"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here needs an NVIDIA GPU and `nvcc` (the kernels build at
first use); without one each skips, deciding inside the test. The file
imports neither jax nor the JAX package, so on a GPU machine without jax
it runs on its own:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -q

Tolerances: f32 cases differ only in summation order (1e-4 on O(1)
values); bf16 cases also round at other points (the forward kernels
round the unnormalised probabilities to bf16 for the tensor cores where
the plain K3 rounds the normalised ones and the plain K4 keeps them in
f32; the backward kernels round P and dS to bf16 where the plain
backward keeps them in f32): a few bf16 ulps, 3e-2 on O(1) values.
"""

import copy
import dataclasses

import pytest
import torch

from walkai_nos_tpu_torch.models import lm as tlm
from walkai_nos_tpu_torch.ops import decode_attention as da

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
PAGE = da.PAGE_ROWS


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, dtype, *, b=5, h=8, kvh=2, hd=64, steps=4, nlog=4, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    nb = b * nlog + 3

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    # Blocks 1 .. nb - 2: block nb - 1 is the scatter's dump block.
    table = (torch.randperm(nb - 2, generator=gen, device=dev) + 1)[: b * nlog]
    # Slot start, the edge of block 0, inside block 1, the last row, and
    # past the table's capacity.
    index = torch.tensor([0, 127, 200, nlog * PAGE - steps, nlog * PAGE + 50])
    return dict(
        q=rnd(b, h, steps, hd), x=rnd(b, steps, h * hd),
        w=rnd(h * hd, (h + 2 * kvh) * hd, std=0.05),
        bias=rnd((h + 2 * kvh) * hd, std=0.1),
        kp=rnd(nb, kvh, PAGE, hd), vp=rnd(nb, kvh, PAGE, hd),
        kn=rnd(b, kvh, steps, hd), vn=rnd(b, kvh, steps, hd),
        table=table.reshape(b, nlog).to(torch.int32),
        index=index[:b].to(dev, torch.int32),
    )


def _close(a, b, dtype):
    torch.testing.assert_close(a.float(), b.float(), atol=TOL[dtype], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("steps", [1, 4, 8])
@pytest.mark.parametrize("kvh", [1, 2, 8])
def test_paged_attention_matches_plain(cuda, dtype, steps, kvh):
    c = _case(cuda, dtype, kvh=kvh, steps=steps)
    before = da.LAUNCHES["paged_attention"]
    got = da.paged_decode_attention(
        c["q"], c["kp"], c["vp"], c["table"], c["index"]
    )
    assert da.LAUNCHES["paged_attention"] == before + 1
    want = da.paged_decode_attention_reference(
        c["q"], c["kp"], c["vp"], c["table"], c["index"]
    )
    _close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_injection_equals_scatter_then_attend(cuda, dtype):
    """K1 with fresh rows injected equals plain attention over pools
    that already hold them (and leaves the pools untouched)."""
    c = _case(cuda, dtype, steps=8)
    kp0 = c["kp"].clone()
    got = da._paged_attention_cuda(
        c["q"], c["kp"], c["vp"], c["table"], c["index"], c["kn"], c["vn"]
    )
    torch.testing.assert_close(c["kp"], kp0, atol=0, rtol=0)
    kp, vp = da.scatter_paged_rows(
        c["kp"].clone(), c["vp"].clone(), c["kn"], c["vn"], c["table"],
        c["index"],
    )
    want = da.paged_decode_attention_reference(
        c["q"], kp, vp, c["table"], c["index"]
    )
    _close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rope", [None, 10000.0])
@pytest.mark.parametrize("bias", [False, True])
def test_qkv_rope_and_fused_match_plain(cuda, dtype, rope, bias):
    c = _case(cuda, dtype, steps=4)
    b = c["bias"] if bias else None
    got = da.qkv_rope_projection(
        c["x"], c["w"], b, c["index"], num_heads=8, kv_heads=2,
        rope_theta=rope,
    )
    want = da.qkv_rope_reference(
        c["x"], c["w"], b, c["index"], num_heads=8, kv_heads=2,
        rope_theta=rope,
    )
    for a, w in zip(got, want):
        _close(a, w, dtype)
    got = da.fused_qkv_paged_attention(
        c["x"], c["w"], b, c["kp"], c["vp"], c["table"], c["index"],
        num_heads=8, rope_theta=rope,
    )
    want = da.fused_qkv_paged_reference(
        c["x"], c["w"], b, c["kp"], c["vp"], c["table"], c["index"],
        num_heads=8, rope_theta=rope,
    )
    for a, w in zip(got, want):
        _close(a, w, dtype)


@pytest.mark.cuda
def test_oversized_query_group_raises_then_next_launch_works(cuda):
    """More query rows per kv head than one block's shared memory holds
    (32 heads on 1 kv head x 8 steps) raises from the C entry point; the
    next launch of a shape that fits is unaffected."""
    big = _case(cuda, torch.float32, b=2, h=32, kvh=1, steps=8)
    with pytest.raises(RuntimeError, match="paged_attention launch failed"):
        da.paged_decode_attention(
            big["q"], big["kp"], big["vp"], big["table"], big["index"]
        )
    c = _case(cuda, torch.float32, steps=1)
    got = da.paged_decode_attention(
        c["q"], c["kp"], c["vp"], c["table"], c["index"]
    )
    want = da.paged_decode_attention_reference(
        c["q"], c["kp"], c["vp"], c["table"], c["index"]
    )
    _close(got, want, torch.float32)


@pytest.mark.cuda
def test_kernel_rows_do_not_depend_on_the_batch(cuda):
    """A slot's outputs are bit-identical whatever the other slots
    hold: the engine's batch-invariance rests on it."""
    c = _case(cuda, torch.bfloat16, steps=1)
    other = _case(cuda, torch.bfloat16, steps=1, seed=1)
    x2, q2 = c["x"].clone(), c["q"].clone()
    x2[1:], q2[1:] = other["x"][1:], other["q"][1:]
    for x, q in ((c["x"], c["q"]), (x2, q2)):
        o = da.fused_qkv_paged_attention(
            x, c["w"], None, c["kp"], c["vp"], c["table"], c["index"],
            num_heads=8, rope_theta=10000.0,
        )
        p = da.paged_decode_attention(
            q, c["kp"], c["vp"], c["table"], c["index"]
        )
        if q is c["q"]:
            first = [t[0].clone() for t in o] + [p[0].clone()]
        else:
            for a, b in zip(first, [t[0] for t in o] + [p[0]]):
                torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.cuda
def test_decoder_fused_route_matches_unfused(cuda):
    """DecoderLM on the GPU: the fused route (K2 + K1 with injection)
    and the unfused route (cuBLAS projection + K1) agree on logits and
    pools, in f32."""
    cfg = tlm.LMConfig(
        vocab_size=128, hidden_dim=128, num_layers=2, num_heads=8,
        num_kv_heads=2, mlp_dim=256, max_seq_len=512, dtype="float32",
        norm="rmsnorm", mlp="swiglu", rope=True, use_bias=False,
        head_bias=False, ragged_decode=True, paged_decode=True,
        paged_blocks=9,
    )
    table = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], device=cuda)
    tokens = torch.randint(0, 128, (2, 70), device=cuda)
    out = []
    for fused in (True, False):
        c = dataclasses.replace(cfg, fused_qkv=fused)
        model = tlm.DecoderLM(c, device=cuda, seed=7)
        cache = tlm.PagedCache.zeros(c, cuda)
        index = torch.tensor([0, 130], device=cuda)
        with torch.inference_mode():
            model(tokens[:, :64], cache, table, index)  # wide prefill
            index += 64
            logits = [model(tokens[:, 64 + i:65 + i], cache, table, index + i)
                      for i in range(6)]
        out.append((torch.cat(logits, 1), cache))
    torch.testing.assert_close(out[0][0], out[1][0], atol=1e-4, rtol=1e-4)
    for a, b in zip(out[0][1].k, out[1][1].k):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


DECODER_FAMILIES = {
    # 2 layers, the second an MoE block (4 experts, top-2): K2 + K1 run
    # on the f32 residual the MoE layer leaves behind.
    "moe": dict(num_heads=8, num_kv_heads=2, mlp_dim=256, norm="rmsnorm",
                mlp="swiglu", rope=True, use_bias=False, head_bias=False,
                num_experts=4, expert_top_k=2),
    # GPT-2 family: biases (K2's bias arm), learned positions (no
    # rotary), MHA (K1 at group 1).
    "gpt2": dict(num_heads=8),
}


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(DECODER_FAMILIES))
def test_decoder_paged_step_launches_k2_k1_and_matches_plain(cuda, family):
    """One paged decode step after a wide prefill, in f32: K2 and K1
    launch once per layer, and the logits and pools equal the plain
    route's (`fused_qkv_paged_reference` on the same CUDA tensors)."""
    cfg = tlm.LMConfig(
        vocab_size=128, hidden_dim=128, num_layers=2, max_seq_len=512,
        dtype="float32", ragged_decode=True, paged_decode=True,
        paged_blocks=13, **DECODER_FAMILIES[family],
    )
    model = tlm.DecoderLM(cfg, device=cuda, seed=11)
    # Distinct blocks: a slot parked on the scratch block reads its own
    # fresh row at an aliased position before the scatter (K1 injects)
    # or after it (the plain route), so its output differs by design.
    table = torch.arange(1, 13, device=cuda, dtype=torch.int32).reshape(3, 4)
    tokens = torch.randint(0, 128, (3, 65), device=cuda)
    out = []
    for plain in (False, True):
        cache = tlm.PagedCache.zeros(cfg, cuda)
        index = torch.tensor([0, 130, 300], device=cuda)
        kernel_route = tlm.fused_qkv_paged_attention
        if plain:
            tlm.fused_qkv_paged_attention = da.fused_qkv_paged_reference
        try:
            with torch.inference_mode():
                model(tokens[:, :64], cache, table, index)  # wide prefill
                da.reset_launch_counts()
                logits = model(tokens[:, 64:], cache, table, index + 64)
        finally:
            tlm.fused_qkv_paged_attention = kernel_route
        launches = dict(da.LAUNCHES)
        want = 0 if plain else cfg.num_layers
        assert launches["qkv_rope"] == launches["paged_attention"] == want, launches
        out.append((logits, cache))
    torch.testing.assert_close(out[0][0], out[1][0], atol=1e-4, rtol=1e-4)
    for a, b in zip(out[0][1].k + out[0][1].v, out[1][1].k + out[1][1].v):
        torch.testing.assert_close(a[1:], b[1:], atol=1e-4, rtol=1e-4)

@pytest.mark.cuda
def test_moe_paged_engine_under_drops_is_repeatable(cuda):
    """The paged engine at the default capacity (1.25), with idle slots
    beside live ones and a lane of 5 requests in 8 (rounded to 8 rows,
    3 of them pad rows parked on the scratch block, as JAX's lane):
    under capacity drops an MoE call's output depends on every row it
    routes, idle and pad rows included, and those rows write and read
    shared rows of the scratch block. Two runs of one engine setup give
    the same tokens, and the capacity formula dropped tokens in lane and
    decode calls alike."""
    from walkai_nos_tpu_torch.models.moe import MoEMlp
    from walkai_nos_tpu_torch.models.serve import ContinuousBatcher

    cfg = tlm.LMConfig(
        vocab_size=128, hidden_dim=128, num_layers=4, num_heads=8,
        num_kv_heads=2, mlp_dim=256, max_seq_len=256, dtype="float32",
        norm="rmsnorm", mlp="swiglu", rope=True, use_bias=False,
        head_bias=False, num_experts=4, moe_every=2, expert_top_k=2,
    )
    model = tlm.DecoderLM(cfg, device=cuda, seed=5)
    drops = {"lane": 0, "decode": 0}

    def count(moe, args):
        h, rows = args[0], (args[1] if len(args) > 1 else None)
        b, s, d = h.shape
        routed = (b if rows is None else rows) * s
        chosen = torch.topk(moe.router(h.reshape(-1, d)[:routed]), moe.top_k).indices
        per_expert = torch.bincount(chosen.reshape(-1), minlength=moe.num_experts)
        drops["lane" if s > 1 else "decode"] += int(
            torch.clamp(per_expert - moe.capacity(routed), min=0).sum())

    gen = torch.Generator().manual_seed(2)
    for m in model.modules():
        if isinstance(m, MoEMlp):
            with torch.no_grad():  # skewed routing: capacity bites
                m.router.bias.copy_(torch.randn(4, generator=gen))
            m.register_forward_pre_hook(count)
    prompts = [torch.randint(0, 128, (int(n),), generator=gen).tolist()
               for n in (20, 37, 9, 50, 28, 14, 41)]
    budgets = [9, 5, 12, 7, 4, 10, 6]
    runs = []
    for _ in range(2):
        engine = ContinuousBatcher(cfg, model, slots=6, cache_len=128,
                                   chunk_steps=2, prefill_chunk=16,
                                   prefill_lanes=8)
        rids = [engine.submit(p, max_new_tokens=m)
                for p, m in zip(prompts[:5], budgets[:5])]
        engine.step()
        rids += [engine.submit(p, max_new_tokens=m)
                 for p, m in zip(prompts[5:], budgets[5:])]
        out = engine.run()
        runs.append([out[r] for r in rids])
    assert drops["lane"] > 0 and drops["decode"] > 0, drops
    assert runs[0] == runs[1]


# -- the int8 arms of K1 and K2 ----------------------------------------------


def _int8_case(dev, dtype, *, kvh=2, steps=4, h=8, seed=0, park=True):
    """`_case` with int8 pools (+ scale pools) quantized from its pools,
    an int8 weight (+ scale row), and with `park` slot 3's table parked
    on the scratch block 0 (whose rows and scales are zero). A parked
    slot's injected rows are garbage by construction (the engine never
    commits them), and a plain scatter into block 0 would show them at
    every logical block, so the injection checks leave it unparked."""
    c = _case(dev, dtype, kvh=kvh, steps=steps, h=h, seed=seed)
    c["kq"], c["ks"] = da.quantize_kv_rows(c["kp"], "int8")
    c["vq"], c["vs"] = da.quantize_kv_rows(c["vp"], "int8")
    nb = c["kp"].shape[0]
    for name in ("kq", "vq"):
        c[name][0] = 0
    for name in ("ks", "vs"):
        c[name][0] = 0
    if park:
        c["table"][3] = 0
    c["wq"], c["ws"] = tlm.quantize_kernel(c["w"])
    c["ones"] = torch.ones(nb, kvh, PAGE, device=dev)
    return c


def _dequantized(c, dtype, inject):
    """The plain semantics of K1's int8 arm: the pools dequantized to
    q's dtype, and with `inject` the fresh rows written at full precision
    (dropped past capacity)."""
    kd = (c["kq"].float() * c["ks"][..., None]).to(dtype)
    vd = (c["vq"].float() * c["vs"][..., None]).to(dtype)
    if inject:
        da.scatter_paged_rows(kd, vd, c["kn"], c["vn"], c["table"], c["index"])
    return kd, vd


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("kvh", [2, 8])  # GQA (8 heads on 2) and MHA
@pytest.mark.parametrize("inject", [False, True])
def test_paged_attention_int8_matches_plain(cuda, dtype, steps, kvh, inject):
    """Ragged indices (block edge, a partial last block, past capacity)
    and a slot parked on block 0."""
    c = _int8_case(cuda, dtype, kvh=kvh, steps=steps, park=not inject)
    before = dict(da.LAUNCHES)
    got = da._paged_attention_cuda(
        c["q"], c["kq"], c["vq"], c["table"], c["index"],
        c["kn"] if inject else None, c["vn"] if inject else None,
        c["ks"], c["vs"],
    )
    assert da.LAUNCHES["paged_attention_int8"] == before["paged_attention_int8"] + 1
    assert da.LAUNCHES["paged_attention"] == before["paged_attention"]
    kd, vd = _dequantized(c, dtype, inject)
    want = da.paged_decode_attention_reference(
        c["q"], kd, vd, c["table"], c["index"]
    )
    _close(got, want, dtype)
    if not inject:
        plain = da.paged_decode_attention_reference(
            c["q"], c["kq"], c["vq"], c["table"], c["index"], c["ks"], c["vs"]
        )
        _close(got, plain, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [False, True])
def test_qkv_rope_and_fused_int8_match_plain(cuda, dtype, bias):
    c = _int8_case(cuda, dtype, steps=4)
    b = c["bias"] if bias else None
    before = dict(da.LAUNCHES)
    got = da.qkv_rope_projection(
        c["x"], c["wq"], b, c["index"], num_heads=8, kv_heads=2,
        rope_theta=10000.0, w_scale=c["ws"],
    )
    assert da.LAUNCHES["qkv_rope_int8"] == before["qkv_rope_int8"] + 1
    assert da.LAUNCHES["qkv_rope"] == before["qkv_rope"]
    want = da.qkv_rope_reference(
        c["x"], c["wq"], b, c["index"], num_heads=8, kv_heads=2,
        rope_theta=10000.0, w_scale=c["ws"],
    )
    for a, w in zip(got, want):
        _close(a, w, dtype)
    kq0 = c["kq"].clone()
    got = da.fused_qkv_paged_attention(
        c["x"], c["wq"], b, c["kq"], c["vq"], c["table"], c["index"],
        num_heads=8, rope_theta=10000.0, w_scale=c["ws"],
        k_scales=c["ks"], v_scales=c["vs"],
    )
    assert torch.equal(c["kq"], kq0)  # the caller scatters, not the kernel
    want = da.fused_qkv_paged_reference(
        c["x"], c["wq"], b, c["kq"], c["vq"], c["table"], c["index"],
        num_heads=8, rope_theta=10000.0, w_scale=c["ws"],
        k_scales=c["ks"], v_scales=c["vs"],
    )
    for a, w in zip(got, want):
        _close(a, w, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sim_arms_bitwise_equal_unquantized(cuda, dtype):
    """Full-precision pools and weight with unit scales run the scaled
    code of K1 and K2 and give the unquantized arms' bits."""
    c = _int8_case(cuda, dtype, steps=5)
    for kn, vn in ((None, None), (c["kn"], c["vn"])):
        plain = da._paged_attention_cuda(
            c["q"], c["kp"], c["vp"], c["table"], c["index"], kn, vn
        )
        sim = da._paged_attention_cuda(
            c["q"], c["kp"], c["vp"], c["table"], c["index"], kn, vn,
            c["ones"], c["ones"],
        )
        assert torch.equal(plain, sim)
    ones_w = torch.ones(c["w"].shape[1], device=cuda)
    for b in (None, c["bias"]):
        args = (c["x"], c["w"], b, c["kp"], c["vp"], c["table"], c["index"])
        plain = da.fused_qkv_paged_attention(
            *args, num_heads=8, rope_theta=10000.0
        )
        sim = da.fused_qkv_paged_attention(
            *args, num_heads=8, rope_theta=10000.0, w_scale=ones_w,
            k_scales=c["ones"], v_scales=c["ones"],
        )
        for a, s in zip(plain, sim):
            assert torch.equal(a, s)


@pytest.mark.cuda
def test_fresh_rows_ignore_poisoned_scales(cuda):
    """Injected rows take scale 1.0: scale pools poisoned at every write
    position leave K1's output unchanged, bit for bit."""
    c = _int8_case(cuda, torch.bfloat16, steps=4, park=False)
    args = (c["q"], c["kq"], c["vq"], c["table"], c["index"], c["kn"], c["vn"])
    clean = da._paged_attention_cuda(*args, c["ks"], c["vs"])
    ks, vs = c["ks"].clone(), c["vs"].clone()
    pos = c["index"].long()[:, None] + torch.arange(4, device=cuda)
    for s in range(pos.shape[0]):
        for p in pos[s].tolist():
            if p < c["table"].shape[1] * PAGE:
                blk = int(c["table"][s, p // PAGE])
                ks[blk, :, p % PAGE] = 1e6
                vs[blk, :, p % PAGE] = 1e6
    assert torch.equal(clean, da._paged_attention_cuda(*args, ks, vs))


@pytest.mark.cuda
def test_int8_without_scales_raises_on_cuda(cuda):
    c = _int8_case(cuda, torch.bfloat16, steps=1)
    with pytest.raises(ValueError, match="scale"):
        da.paged_decode_attention(
            c["q"], c["kq"], c["vq"], c["table"], c["index"]
        )
    with pytest.raises(ValueError, match="w_scale"):
        da.qkv_rope_projection(
            c["x"], c["wq"], None, c["index"], num_heads=8, kv_heads=2
        )


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False])
def test_decoder_sim_equals_unquantized_on_gpu(cuda, fused):
    """DecoderLM in bf16 on the GPU: "int8-sim" KV and weights give the
    unquantized model's logits bit for bit, on the fused route (K2 + K1
    with their scales) and the unfused one."""
    cfg = tlm.LMConfig(
        vocab_size=128, hidden_dim=128, num_layers=2, num_heads=8,
        num_kv_heads=2, mlp_dim=256, max_seq_len=512, dtype="bfloat16",
        norm="rmsnorm", mlp="swiglu", rope=True, use_bias=False,
        head_bias=False, ragged_decode=True, paged_decode=True,
        paged_blocks=9, fused_qkv=fused,
    )
    table = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], device=cuda)
    tokens = torch.randint(0, 128, (2, 70), device=cuda)
    out = []
    for q in ("model", "int8-sim"):
        c = dataclasses.replace(cfg, kv_dtype=q, w_dtype=q)
        model = tlm.DecoderLM(c, device=cuda, seed=7)
        cache = tlm.PagedCache.zeros(c, cuda)
        index = torch.tensor([0, 130], device=cuda)
        with torch.inference_mode():
            model(tokens[:, :64], cache, table, index)
            index += 64
            out.append(torch.cat([
                model(tokens[:, 64 + i:65 + i], cache, table, index + i)
                for i in range(6)
            ], 1))
    assert torch.equal(out[0], out[1])


# -- K3-K6: full-sequence attention ------------------------------------------

from walkai_nos_tpu_torch.ops import attention as fa  # noqa: E402

# Per-tensor rule: max |kernel - plain| <= REL * max |plain| + ABS (f32:
# summation order only; bf16: outputs rounded to bf16 at other points).
REL_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 4e-3)}

# (b, h, sq, sk, d, causal, kv_len)
ATTN_CASES = {
    "vit": (2, 6, 296, 296, 64, False, 296),
    "causal": (2, 3, 200, 200, 64, True, 200),
    "causal_sq_lt_sk": (1, 2, 100, 250, 64, True, 250),
    "causal_sq_gt_sk": (1, 2, 150, 70, 64, True, 70),
    "kv_tail": (2, 2, 130, 192, 64, False, 150),
    "causal_kv_tail": (2, 2, 130, 192, 64, True, 150),
    "d128": (1, 2, 96, 160, 128, True, 160),
    "d40": (1, 2, 77, 77, 40, False, 77),
    # The last tile narrower than one 16-row mma fragment; fewer keys
    # than one fragment; a long causal sequence at LM-training width; the
    # wide head at the ViT's length.
    "s17": (2, 2, 17, 17, 64, False, 17),
    "sk8_causal": (2, 2, 8, 8, 64, True, 8),
    "lm_causal": (1, 4, 1024, 1024, 64, True, 1024),
    "d128_s296": (1, 2, 296, 296, 128, False, 296),
    # At 512 query rows and more the forward runs two warpgroups a CTA:
    # rows that see no key, a kv tail at d 128.
    "long_causal_sq_gt_sk": (1, 2, 600, 300, 64, True, 300),
    "long_d128_kv_tail": (1, 2, 520, 640, 128, False, 600),
}


def _close_rel(got, want, dtype, what=""):
    rel, floor = REL_TOL[dtype]
    err = float((got.detach().float() - want.detach().float()).abs().max())
    tol = rel * float(want.detach().float().abs().max()) + floor
    assert err <= tol, (what, err, tol)


def _attn_case(dev, dtype, name, seed=0):
    b, h, sq, sk, d, causal, kv_len = ATTN_CASES[name]
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    return dict(q=rnd(b, h, sq, d), k=rnd(b, h, sk, d), v=rnd(b, h, sk, d),
                g=rnd(b, h, sq, d), g_lse=rnd(b, h, sq).float(),
                causal=causal, kv_len=kv_len)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(ATTN_CASES))
def test_flash_forward_matches_plain(cuda, dtype, name):
    c = _attn_case(cuda, dtype, name)
    before = fa.LAUNCHES["flash_fwd"]
    out, lse = fa._flash_fwd_cuda(c["q"], c["k"], c["v"], c["causal"], c["kv_len"])
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_fwd"] == before + 1
    want, want_lse = fa.flash_reference(
        c["q"], c["k"], c["v"], causal=c["causal"], kv_len=c["kv_len"]
    )
    _close_rel(out, want, dtype, "out")
    # lse is f32 from inputs of the case's dtype on both sides.
    _close_rel(lse, want_lse, torch.float32, "lse")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(ATTN_CASES))
def test_flash_backward_matches_plain(cuda, dtype, name):
    c = _attn_case(cuda, dtype, name, seed=1)
    out, lse = fa.flash_reference(
        c["q"], c["k"], c["v"], causal=c["causal"], kv_len=c["kv_len"]
    )
    args = (c["q"], c["k"], c["v"], out, lse, c["g"])
    got = fa._flash_bwd_cuda(*args, c["g_lse"], c["causal"], c["kv_len"])
    want = fa.flash_backward_reference(
        *args, causal=c["causal"], kv_len=c["kv_len"], g_lse=c["g_lse"]
    )
    for a, w, n in zip(got, want, ("dq", "dk", "dv")):
        assert torch.isfinite(a.float()).all(), n
        _close_rel(a, w, dtype, n)


# (b, s, h, d) of the packed cases: the ViT's, a wide head, and fewer
# rows than one 16-row fragment.
PACKED_CASES = {"vit": (3, 296, 6, 64), "d128": (2, 296, 2, 128), "s17": (3, 17, 6, 64)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(PACKED_CASES))
def test_packed_forward_and_grad_match_plain(cuda, dtype, name):
    """K3 on the packed tensor as it lies (a column slice of a wider
    buffer, so rows are strided), and the packed backward (K4 recompute,
    K5 + K6 into the packed gradient) against the plain versions."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    b, s, h, d = PACKED_CASES[name]
    wide = torch.randn(b, s, 3 * h * d + 16, generator=gen, device=cuda).to(dtype)
    qkv = wide[..., : 3 * h * d]
    fa.reset_launch_counts()
    out = fa._packed_cuda(qkv, h)
    _close_rel(out, fa.packed_reference(qkv, h), dtype, "out")
    g = torch.randn(b, s, h * d, generator=gen, device=cuda).to(dtype)
    x = qkv.detach().clone().requires_grad_(True)
    fa.flash_attention_packed(x, h).backward(g)
    assert fa.LAUNCHES == {
        "packed_attention": 2, "flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1,
    }
    y = qkv.detach().cpu().float().requires_grad_(True)
    fa.flash_attention_packed(y, h).backward(g.cpu().float())
    _close_rel(x.grad, y.grad.to(cuda), dtype, "dqkv")


def _unaligned_case(dev, d, col0, b=2, h=3, sq=90, sk=130):
    """q, k, v, g: bf16 views cut `col0` columns into wider buffers."""
    gen = torch.Generator(device=dev).manual_seed(6)

    def view(s):
        wide = torch.randn(b, h, s, d + 8, generator=gen, device=dev)
        return wide.to(torch.bfloat16)[..., col0:col0 + d]

    return view(sq), view(sk), view(sk), view(sq)


@pytest.mark.cuda
@pytest.mark.parametrize("d, col0", [(64, 1), (36, 0), (128, 1)])
def test_forward_of_unaligned_rows_matches_plain(cuda, d, col0):
    """The forward kernels' per-element load path: rows whose start is not
    16-byte aligned, and rows of d * 2 bytes not a multiple of 16; K4
    causal with sq < sk, and K3 on a packed tensor cut one column into a
    wider buffer."""
    for sq, sk in ((90, 130), (520, 600)):  # one and two warpgroups a CTA
        q, k, v, _ = _unaligned_case(cuda, d, col0, sq=sq, sk=sk)
        out, lse = fa._flash_fwd_cuda(q, k, v, True, sk)
        want, want_lse = fa.flash_reference(q, k, v, causal=True)
        _close_rel(out, want, torch.bfloat16, "out")
        _close_rel(lse, want_lse, torch.float32, "lse")
    gen = torch.Generator(device=cuda).manual_seed(9)
    h = 2
    wide = torch.randn(2, 40, 3 * h * d + 8, generator=gen, device=cuda)
    qkv = wide.to(torch.bfloat16)[..., col0:col0 + 3 * h * d]
    _close_rel(fa._packed_cuda(qkv, h), fa.packed_reference(qkv, h),
               torch.bfloat16, "packed")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["vit", "causal_sq_gt_sk", "causal_kv_tail", "d128"])
def test_forward_lse_feeds_the_backward(cuda, dtype, name):
    """K5 + K6 over K4's (out, lse) give the plain backward's gradients
    over the plain forward's: the kernel's lse is the one the backward
    rebuilds P from."""
    c = _attn_case(cuda, dtype, name, seed=10)
    out, lse = fa._flash_fwd_cuda(c["q"], c["k"], c["v"], c["causal"], c["kv_len"])
    got = fa._flash_bwd_cuda(c["q"], c["k"], c["v"], out, lse, c["g"], c["g_lse"],
                             c["causal"], c["kv_len"])
    ro, rl = fa.flash_reference(
        c["q"], c["k"], c["v"], causal=c["causal"], kv_len=c["kv_len"]
    )
    want = fa.flash_backward_reference(
        c["q"], c["k"], c["v"], ro, rl, c["g"], causal=c["causal"],
        kv_len=c["kv_len"], g_lse=c["g_lse"],
    )
    for a, w, n in zip(got, want, ("dq", "dk", "dv")):
        assert torch.isfinite(a.float()).all(), n
        _close_rel(a, w, dtype, n)


@pytest.mark.cuda
@pytest.mark.parametrize("d, col0", [(64, 1), (36, 0), (128, 1)])
def test_backward_of_unaligned_rows_matches_plain(cuda, d, col0):
    """Rows whose start is not 16-byte aligned (views cut one column into
    a wider buffer) and rows of d * 2 bytes not a multiple of 16 take the
    kernels' per-element load path, at both head-width arms; bf16, causal
    with sq < sk."""
    q, k, v, g = _unaligned_case(cuda, d, col0)
    out, lse = fa.flash_reference(q, k, v, causal=True)
    got = fa._flash_bwd_cuda(q, k, v, out, lse, g, None, True, k.shape[2])
    want = fa.flash_backward_reference(q, k, v, out, lse, g, causal=True)
    for a, w, n in zip(got, want, ("dq", "dk", "dv")):
        _close_rel(a, w, torch.bfloat16, n)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["vit", "causal_sq_gt_sk", "d40"])
def test_dq_kernel_writes_the_row_term(cuda, dtype, name):
    """K5's D' buffer is `_row_term(g, out, g_lse)`: f32 on both sides from
    the same inputs, other summation order."""
    c = _attn_case(cuda, dtype, name, seed=7)
    out, lse = fa.flash_reference(
        c["q"], c["k"], c["v"], causal=c["causal"], kv_len=c["kv_len"]
    )
    _, dcap = fa._flash_dq_cuda(
        c["q"], c["k"], c["v"], c["g"], out, lse, c["g_lse"], c["causal"],
        c["kv_len"],
    )
    assert dcap.dtype == torch.float32 and dcap.shape == lse.shape
    _close_rel(dcap, fa._row_term(c["g"], out, c["g_lse"]), torch.float32, "dcap")


@pytest.mark.cuda
def test_backward_is_two_launches(cuda):
    """The backward of a CUDA tensor is K5 then K6 and no other device
    work: one launch of each counted, two kernels on the device."""
    from torch.profiler import ProfilerActivity, profile, schedule

    c = _attn_case(cuda, torch.bfloat16, "causal", seed=8)
    out, lse = fa._flash_fwd_cuda(c["q"], c["k"], c["v"], True, c["kv_len"])
    args = (c["q"], c["k"], c["v"], out, lse, c["g"], c["g_lse"], True, c["kv_len"])
    fa._flash_bwd_cuda(*args)  # the first call builds and loads the kernels
    torch.cuda.synchronize()
    # One warm-up step, then one recorded step of one backward. The
    # profiler was seen to drop the first device launch of a recorded
    # step, so ~1 ms spin kernels before and after the backward keep its
    # kernels well inside the window; the spins are left out of the count.
    events = []
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: events.extend(p.events())) as prof:
        for _ in range(2):
            fa.reset_launch_counts()
            torch.cuda._sleep(2_000_000)
            fa._flash_bwd_cuda(*args)
            torch.cuda._sleep(2_000_000)
            torch.cuda.synchronize()
            prof.step()
    assert fa.LAUNCHES == {
        "packed_attention": 0, "flash_fwd": 0, "flash_dq": 1, "flash_dkv": 1,
    }
    kernels = [
        e.name for e in sorted(events, key=lambda e: e.time_range.start)
        if e.device_type.name == "CUDA" and "spin_kernel" not in e.name
    ]
    assert len(kernels) == 2, kernels
    assert "flash_dq" in kernels[0] and "flash_dkv" in kernels[1], kernels


@pytest.mark.cuda
def test_backward_is_bitwise_repeatable(cuda):
    c = _attn_case(cuda, torch.bfloat16, "vit", seed=3)
    out, lse = fa._flash_fwd_cuda(c["q"], c["k"], c["v"], False, c["kv_len"])
    runs = [
        fa._flash_bwd_cuda(c["q"], c["k"], c["v"], out, lse, c["g"], None,
                           False, c["kv_len"])
        for _ in range(2)
    ]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_head_dim_above_128_raises(cuda):
    q = torch.zeros(1, 1, 8, 136, device=cuda)
    with pytest.raises(ValueError, match="head_dim 136"):
        fa.flash_attention(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_public_functions_grads_match_plain(cuda, causal):
    """flash_attention_with_lse through autograd on the card (K4, then
    K5 + K6 with the lse cotangent) against the same function on the CPU
    (the plain versions), in f32."""
    c = _attn_case(cuda, torch.float32, "causal_sq_lt_sk" if causal else "kv_tail", seed=4)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        q, k, v = (c[n].to(dev).detach().requires_grad_(True) for n in "qkv")
        if causal:
            out, lse = fa.flash_attention_with_lse(q, k, v, causal=True)
            loss = (out * c["g"].to(dev)).sum() + (lse * c["g_lse"].to(dev)).sum()
        else:
            out = fa.flash_attention(q, k, v, kv_len=c["kv_len"])
            loss = (out * c["g"].to(dev)).sum()
        loss.backward()
        grads.append([t.grad for t in (q, k, v)])
    for a, w, n in zip(grads[0], grads[1], ("dq", "dk", "dv")):
        _close_rel(a, w.to(cuda), torch.float32, n)


@pytest.mark.cuda
def test_vit_kernel_path_matches_plain_path(cuda):
    """ViTDetector on the card (K3 forward, K4-K6 backward) against the
    same parameters and images on the CPU (plain attention), in f32:
    outputs and every parameter's gradient."""
    from walkai_nos_tpu_torch.models.vit import VIT_TINY, ViTDetector

    cfg = dataclasses.replace(VIT_TINY, dtype="float32")
    images = torch.randn(3, 64, 64, 3, generator=torch.Generator().manual_seed(5))
    plain = ViTDetector(cfg, device="cpu", seed=3)
    results = []
    for dev, model in ((cuda, copy.deepcopy(plain).to(cuda)), (torch.device("cpu"), plain)):
        out = model(images.to(dev))
        (out["logits"].square().sum() + out["boxes"].sum()).backward()
        results.append((out, {n: p.grad for n, p in model.named_parameters()}))
    (out_k, g_k), (out_p, g_p) = results
    for key in ("logits", "boxes"):
        _close_rel(out_k[key], out_p[key].to(cuda), torch.float32, key)
    for name, g in g_p.items():
        _close_rel(g_k[name], g.to(cuda), torch.float32, name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lm_training_attention_matches_plain(cuda, dtype):
    """K4, then K5 + K6, causal at TinyLlama's training shape (32 query
    heads over K/V repeated from 4 kv heads, head_dim 64, 2048 tokens)
    against the plain versions, and the gradients summed back onto the
    kv heads as autograd of `repeat_interleave` sums them."""
    b, h, kvh, s, d = 1, 32, 4, 2048, 64
    gen = torch.Generator(device=cuda).manual_seed(7)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)

    q, g = rnd(b, h, s, d), rnd(b, h, s, d)
    k, v = (rnd(b, kvh, s, d).repeat_interleave(h // kvh, dim=1) for _ in range(2))
    out, lse = fa._flash_fwd_cuda(q, k, v, True, s)
    want, want_lse = fa.flash_reference(q, k, v, causal=True)
    _close_rel(out, want, dtype, "out")
    _close_rel(lse, want_lse, torch.float32, "lse")
    got = fa._flash_bwd_cuda(q, k, v, want, want_lse, g, None, True, s)
    ref = fa.flash_backward_reference(q, k, v, want, want_lse, g, causal=True)
    for a, w, n in zip(got, ref, ("dq", "dk", "dv")):
        _close_rel(a, w, dtype, n)
    for a, w, n in zip(got[1:], ref[1:], ("dk", "dv")):
        def per_kv_head(t):
            return t.float().unflatten(1, (kvh, h // kvh)).sum(2)
        _close_rel(per_kv_head(a), per_kv_head(w), dtype, n + " per kv head")


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_lm_training_path_launches_and_matches_plain(cuda, remat):
    """The LM's no-cache forward and backward on the card launch K4 once
    per layer (twice with remat: the recompute), K5 and K6 once per
    layer, and give the loss and every parameter's gradient of the same
    training build on the CPU (plain attention), in f32."""
    cfg = tlm.LMConfig(
        vocab_size=96, hidden_dim=128, num_layers=3, num_heads=4, num_kv_heads=2,
        mlp_dim=192, max_seq_len=160, dtype="float32", norm="rmsnorm", mlp="swiglu",
        rope=True, use_bias=False, head_bias=False, remat=remat,
    )
    tokens = torch.randint(0, 96, (2, 150), generator=torch.Generator().manual_seed(3))
    plain = tlm.init_lm_state(cfg, seed=5, device="cpu").params
    results = []
    for dev, model in ((cuda, copy.deepcopy(plain).to(cuda)), (torch.device("cpu"), plain)):
        fa.reset_launch_counts()
        t = tokens.to(dev)
        loss = tlm.lm_loss(model(t), t)
        loss.backward()
        results.append((loss, {n: p.grad for n, p in model.named_parameters()},
                        dict(fa.LAUNCHES)))
    (loss_k, g_k, launches), (loss_p, g_p, _) = results
    n = cfg.num_layers
    assert launches == {"packed_attention": 0, "flash_fwd": n * (2 if remat else 1),
                        "flash_dq": n, "flash_dkv": n}
    _close_rel(loss_k, loss_p.to(cuda), torch.float32, "loss")
    for name, g in g_p.items():
        _close_rel(g_k[name], g.to(cuda), torch.float32, name)


# -- K7: dense-cache decode attention ----------------------------------------


def _dense_case(dev, dtype, *, b=5, h=4, kvh=2, hd=64, steps=3, cache_len=256,
                seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    return rnd(b, h, steps, hd), rnd(b, kvh, cache_len, hd), rnd(b, kvh, cache_len, hd)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cache_len", [256, 384, 200])
@pytest.mark.parametrize("steps", [1, 3, 8])
@pytest.mark.parametrize("kvh", [1, 2, 4])
def test_dense_decode_attention_matches_plain(cuda, dtype, cache_len, steps, kvh):
    """Per-row indices at the slot start, a 128-row edge, inside and one
    past the cache; a shared index; 4-d and (one step) 3-d q; cache
    lengths on and off the 64-row tile."""
    q, k, v = _dense_case(cuda, dtype, kvh=kvh, steps=steps, cache_len=cache_len,
                          seed=kvh * 10 + steps)
    ragged = torch.tensor([0, 126, 127, 128, cache_len], device=cuda, dtype=torch.int32)
    shared = torch.tensor(cache_len - steps - 7, device=cuda, dtype=torch.int32)
    for index in (ragged, shared):
        before = da.LAUNCHES["decode_attention"]
        got = da.decode_attention(q, k, v, index)
        assert da.LAUNCHES["decode_attention"] == before + 1
        _close_rel(got, da.decode_attention_reference(q, k, v, index), dtype)
        if steps == 1:
            got3 = da.decode_attention(q[:, :, 0], k, v, index)
            torch.testing.assert_close(got3, got[:, :, 0], atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_decode_attention_generate_shapes(cuda, dtype):
    """TinyLlama's groups (32 heads over 4 kv heads) at 8 steps, head
    dim 128, and MHA; an int index."""
    for h, kvh, hd, steps in ((32, 4, 64, 8), (8, 8, 128, 2), (32, 32, 64, 1)):
        q, k, v = _dense_case(cuda, dtype, b=2, h=h, kvh=kvh, hd=hd, steps=steps,
                              cache_len=1024)
        _close_rel(da.decode_attention(q, k, v, 1000),
                   da.decode_attention_reference(q, k, v, 1000), dtype)


@pytest.mark.cuda
def test_dense_decode_attention_rows_do_not_depend_on_the_batch(cuda):
    """Row 0's output is bit-identical whatever the other rows hold and
    wherever their indices lie (the split comes from the shapes only)."""
    q, k, v = _dense_case(cuda, torch.bfloat16, steps=1, cache_len=512)
    q2, k2, v2 = _dense_case(cuda, torch.bfloat16, steps=1, cache_len=512, seed=1)
    q2[0], k2[0], v2[0] = q[0], k[0], v[0]
    a = da.decode_attention(q, k, v, torch.tensor([300, 1, 2, 3, 4], device=cuda))
    b = da.decode_attention(q2, k2, v2, torch.tensor([300, 511, 600, 0, 9], device=cuda))
    torch.testing.assert_close(a[0], b[0], atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h, kvh, hd, steps", [
    (8, 2, 80, 3),     # GQA at head_dim 80
    (32, 2, 64, 5),    # 16 heads per kv head at a 5-step verify: 80 rows
    (4, 2, 36, 4),     # head_dim 36: bf16 rows of 72 bytes, loaded per element
    (16, 1, 256, 2),   # the widest head: f32 takes 32-row chunks
])
def test_dense_decode_attention_any_group_and_head_dim(cuda, dtype, h, kvh, hd, steps):
    """Shapes `_gqa_pallas` takes: any head_dim up to 256 and any group *
    steps (more than 64 query rows per kv head go to more CTAs)."""
    q, k, v = _dense_case(cuda, dtype, b=3, h=h, kvh=kvh, hd=hd, steps=steps,
                          cache_len=320, seed=h + hd + steps)
    for index in (torch.tensor([0, 130, 320], device=cuda, dtype=torch.int32), 200):
        _close_rel(da.decode_attention(q, k, v, index),
                   da.decode_attention_reference(q, k, v, index), dtype)


@pytest.mark.cuda
def test_dense_decode_attention_limits_raise(cuda):
    q, k, v = _dense_case(cuda, torch.float32, hd=264)
    with pytest.raises(ValueError, match="head_dim"):
        da.decode_attention(q, k, v, 10)
    q, k, v = _dense_case(cuda, torch.float32)
    with pytest.raises(TypeError, match="dtype"):
        da.decode_attention(q, k.bfloat16(), v.bfloat16(), 10)


@pytest.mark.cuda
@pytest.mark.parametrize("kvh,decode_kernel", [(2, False), (8, True)])
def test_decoder_dense_cache_on_the_card_matches_cpu(cuda, kvh, decode_kernel):
    """DecoderLM over a ragged DenseCache on the card (K7 for the steps)
    against the same weights on the CPU (plain attention), in f32: a
    prefill, then single steps and a 5-step verify-shaped call, one row
    stepping past the cache's end."""
    cfg = tlm.LMConfig(
        vocab_size=128, hidden_dim=512, num_layers=2, num_heads=8,
        num_kv_heads=kvh, mlp_dim=256, max_seq_len=512, dtype="float32",
        norm="rmsnorm", mlp="swiglu", rope=True, use_bias=False,
        head_bias=False, ragged_decode=True, decode_kernel=decode_kernel,
    )
    tokens = torch.randint(0, 128, (2, 90), generator=torch.Generator().manual_seed(1))
    plain = tlm.DecoderLM(cfg, device="cpu", seed=7)
    out = []
    for dev, model in ((cuda, copy.deepcopy(plain).to(cuda)), (torch.device("cpu"), plain)):
        cache = tlm.DenseCache.zeros(cfg, 2, dev, cache_len=128)
        with torch.inference_mode():
            logits = [model(tokens[:, :64].to(dev), cache)]
            cache.index[1] = 120  # row 1 runs past the 128-row cache
            logits += [model(tokens[:, 64 + i:65 + i].to(dev), cache) for i in range(6)]
            logits.append(model(tokens[:, 80:85].to(dev), cache))
        out.append(torch.cat([x.float().cpu() for x in logits], 1))
    torch.testing.assert_close(out[0], out[1], atol=1e-4, rtol=1e-4)


# -- K1 and K7: the cp.async ring and the visible-range split ------------------


def _rows_close(got, want, dtype):
    """Per (batch row, head) rule of `_close_rel`: outputs over long
    caches are small, so each row is held to its own scale."""
    for g, w in zip(got.flatten(0, 1), want.flatten(0, 1)):
        _close_rel(g, w, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_decode_short_visible_range_leaves_splits_empty(cuda, dtype):
    """S 2048 with rows at index 0, 63, 64 and past the cache: most
    splits of the first three rows find no visible tile."""
    q, k, v = _dense_case(cuda, dtype, b=4, h=8, kvh=2, steps=2, cache_len=2048,
                          seed=3)
    for index in ([0, 63, 64, 2100], [2100, 64, 63, 0]):
        index = torch.tensor(index, device=cuda, dtype=torch.int32)
        _rows_close(da.decode_attention(q, k, v, index),
                    da.decode_attention_reference(q, k, v, index), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_decode_more_tiles_per_split_than_stages(cuda, dtype):
    """S 8192 at one batch row: each CTA walks many tiles through its
    ring, which wraps around its stages."""
    q, k, v = _dense_case(cuda, dtype, b=1, h=8, kvh=1, steps=1, cache_len=8192,
                          seed=4)
    for index in (8191, 5000):
        _rows_close(da.decode_attention(q, k, v, index),
                    da.decode_attention_reference(q, k, v, index), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [256, 80])
def test_dense_decode_wide_and_unaligned_heads_long_cache(cuda, dtype, hd):
    """head_dim 256 (Q fragments read from shared memory, 32-row chunks)
    and 80 (padded to 128 columns) over a 2048-row cache, ragged."""
    q, k, v = _dense_case(cuda, dtype, b=3, h=16, kvh=2, hd=hd, steps=3,
                          cache_len=2048, seed=hd)
    index = torch.tensor([5, 1500, 2047], device=cuda, dtype=torch.int32)
    _rows_close(da.decode_attention(q, k, v, index),
                da.decode_attention_reference(q, k, v, index), dtype)


def _long_paged_case(dev, dtype, int8, steps, seed=0):
    """A GQA group (8 heads over 2 kv heads) over an 8-block (1024-row)
    table: slots at 0, 127, 128, 1023 and past capacity; with `int8` the
    pools also quantized (with their scale pools)."""
    c = _case(dev, dtype, b=5, h=8, kvh=2, steps=steps, nlog=8, seed=seed)
    c["index"] = torch.tensor([0, 127, 128, 1023, 1100], device=dev,
                              dtype=torch.int32)
    if int8:
        c["kq"], c["ks"] = da.quantize_kv_rows(c["kp"], "int8")
        c["vq"], c["vs"] = da.quantize_kv_rows(c["vp"], "int8")
    return c


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("inject", [False, True])
def test_paged_attention_ragged_long_table(cuda, dtype, int8, inject):
    """K1 over an 8-block table, slots at 0, 127, 128, 1023 and past
    capacity, each arm with and without fresh-row injection."""
    c = _long_paged_case(cuda, dtype, int8, steps=3)
    kn, vn = (c["kn"], c["vn"]) if inject else (None, None)
    if int8:
        got = da._paged_attention_cuda(c["q"], c["kq"], c["vq"], c["table"],
                                       c["index"], kn, vn, c["ks"], c["vs"])
        kp = (c["kq"].float() * c["ks"][..., None]).to(dtype)
        vp = (c["vq"].float() * c["vs"][..., None]).to(dtype)
    else:
        got = da._paged_attention_cuda(c["q"], c["kp"], c["vp"], c["table"],
                                       c["index"], kn, vn)
        kp, vp = c["kp"].clone(), c["vp"].clone()
    if inject:
        da.scatter_paged_rows(kp, vp, c["kn"], c["vn"], c["table"], c["index"])
    want = da.paged_decode_attention_reference(c["q"], kp, vp, c["table"],
                                               c["index"])
    _rows_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_decode_kernels_are_bitwise_repeatable(cuda, int8):
    """Two calls on the same inputs give the same bits (K1 and K7): the
    splits combine in a fixed order whichever CTA finishes last."""
    c = _long_paged_case(cuda, torch.bfloat16, int8, steps=1)
    pools = (c["kq"], c["vq"]) if int8 else (c["kp"], c["vp"])
    sc = (c["ks"], c["vs"]) if int8 else (None, None)
    runs = [da._paged_attention_cuda(c["q"], *pools, c["table"], c["index"],
                                     c["kn"], c["vn"], *sc) for _ in range(3)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    q, k, v = _dense_case(cuda, torch.bfloat16, b=4, h=8, kvh=2, steps=1,
                          cache_len=2048)
    index = torch.tensor([2000, 5, 1024, 700], device=cuda, dtype=torch.int32)
    runs = [da.decode_attention(q, k, v, index) for _ in range(3)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_paged_attention_rows_do_not_depend_on_the_batch(cuda, int8):
    """Slot 0's output is bit-identical whatever the other slots hold and
    wherever their indices lie (the split count comes from the shapes,
    each split's share of the tiles from the slot's own index)."""
    c = _long_paged_case(cuda, torch.bfloat16, int8, steps=1)
    other = _long_paged_case(cuda, torch.bfloat16, int8, steps=1, seed=1)
    q2 = c["q"].clone()
    q2[1:] = other["q"][1:]
    idx2 = torch.tensor([0, 1023, 5, 1100, 300], device=cuda, dtype=torch.int32)
    idx2[0] = c["index"][0] = 900
    pools = (c["kq"], c["vq"]) if int8 else (c["kp"], c["vp"])
    sc = (c["ks"], c["vs"]) if int8 else (None, None)
    a = da._paged_attention_cuda(c["q"], *pools, c["table"], c["index"],
                                 c["kn"], c["vn"], *sc)
    kn2, vn2 = c["kn"].clone(), c["vn"].clone()
    kn2[1:], vn2[1:] = other["kn"][1:], other["vn"][1:]
    b = da._paged_attention_cuda(q2, *pools, c["table"], idx2, kn2, vn2, *sc)
    torch.testing.assert_close(a[0], b[0], atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("h, kvh, hd, steps", [
    (16, 1, 64, 8),    # 128 query rows a kv head: two row chunks in bf16
    (8, 2, 128, 3),    # head_dim 128
])
def test_paged_attention_row_chunks_and_wide_heads(cuda, int8, h, kvh, hd, steps):
    """K1 in bf16 beyond the serving shape: a group of more rows than one
    CTA holds, and a 128-wide head, with fresh-row injection, in both
    pool arms."""
    c = _case(cuda, torch.bfloat16, b=4, h=h, kvh=kvh, hd=hd, steps=steps,
              nlog=4, seed=hd + steps)
    kp, vp = c["kp"], c["vp"]
    sc = (None, None)
    if int8:
        kp, ks = da.quantize_kv_rows(kp, "int8")
        vp, vs = da.quantize_kv_rows(vp, "int8")
        sc = (ks, vs)
    got = da._paged_attention_cuda(c["q"], kp, vp, c["table"], c["index"],
                                   c["kn"], c["vn"], *sc)
    if int8:
        kp = (kp.float() * sc[0][..., None]).to(torch.bfloat16)
        vp = (vp.float() * sc[1][..., None]).to(torch.bfloat16)
    kp, vp = da.scatter_paged_rows(kp.clone(), vp.clone(), c["kn"], c["vn"],
                                   c["table"], c["index"])
    want = da.paged_decode_attention_reference(c["q"], kp, vp, c["table"],
                                               c["index"])
    _rows_close(got, want, torch.bfloat16)


# K2 (csrc/qkv_rope.cu) beyond the serving shape: rows per call M = batch
# x steps of 8, 64 (one CTA's rows) and 72 (two row blocks), head_dim 32,
# 64 and 128, a d_model that is not a multiple of the 64-row k tile (200)
# and one whose bf16 rows do not start on 16 bytes (196). Per slot, max
# |kernel - plain| <= REL * max |plain| + ABS (the rule of chip_smoke.py):
# bf16 rounds the f32 sum once on both sides but sums in another order.
K2_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 4e-3)}
K2_SHAPES = {  # name: (batch, steps, d_model)
    "m8": (8, 1, 512), "m64": (8, 8, 512), "m72_k200": (9, 8, 200),
    "m8_k196": (8, 1, 196),
}


def _k2_case(dev, dtype, shape, hd, *, int8=False, h=4, kvh=2, seed=0):
    b, steps, dm = K2_SHAPES[shape]
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*s, std=1.0):
        return (torch.randn(s, generator=gen, device=dev) * std).to(dtype)

    dout = (h + 2 * kvh) * hd
    w = rnd(dm, dout, std=0.05)
    c = dict(x=rnd(b, steps, dm), w=w, bias=rnd(dout, std=0.1),
             index=torch.randint(0, 3000, (b,), generator=gen, device=dev,
                                 dtype=torch.int32),
             proj=dict(num_heads=h, kv_heads=kvh))
    if int8:
        c["w"], c["proj"]["w_scale"] = tlm.quantize_kernel(w)
    return c


def _k2_close(got, want, dtype):
    rel, floor = K2_TOL[dtype]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        for gs, ws in zip(g.float(), w.float()):  # one slot at a time
            err = (gs - ws).abs().max().item()
            assert err <= rel * ws.abs().max().item() + floor, err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("shape", sorted(K2_SHAPES))
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("bias, rope", [
    (False, None), (True, None), (False, 10000.0), (True, 10000.0)])
def test_qkv_rope_shapes_match_plain(cuda, dtype, int8, shape, hd, bias, rope):
    c = _k2_case(cuda, dtype, shape, hd, int8=int8, seed=hd)
    b = c["bias"] if bias else None
    got = da.qkv_rope_projection(c["x"], c["w"], b, c["index"],
                                 rope_theta=rope, **c["proj"])
    want = da.qkv_rope_reference(c["x"], c["w"], b, c["index"],
                                 rope_theta=rope, **c["proj"])
    _k2_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("shape", ["m8", "m64", "m72_k200"])
def test_qkv_rope_one_launch_and_repeatable(cuda, int8, shape):
    """Each call moves its arm's launch counter by one, and two calls on
    the same inputs give the same bits (the cells' tickets are left
    zero, so the second call combines as the first did)."""
    c = _k2_case(cuda, torch.bfloat16, shape, 64, int8=int8, seed=1)
    arm, other = (("qkv_rope_int8", "qkv_rope") if int8
                  else ("qkv_rope", "qkv_rope_int8"))
    outs = []
    for _ in range(2):
        before = dict(da.LAUNCHES)
        outs.append(da.qkv_rope_projection(
            c["x"], c["w"], c["bias"], c["index"], rope_theta=10000.0,
            **c["proj"]))
        assert da.LAUNCHES[arm] == before[arm] + 1
        assert da.LAUNCHES[other] == before[other]
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_qkv_rope_rows_do_not_depend_on_the_batch_at_steps_8(cuda, int8):
    """Slot 0's q / k_new / v_new at 8 steps are bit-identical whatever
    the other slots' rows hold."""
    c = _k2_case(cuda, torch.bfloat16, "m64", 64, int8=int8, seed=2)
    other = _k2_case(cuda, torch.bfloat16, "m64", 64, seed=3)
    x2 = c["x"].clone()
    x2[1:] = other["x"][1:]
    first = da.qkv_rope_projection(c["x"], c["w"], c["bias"], c["index"],
                                   rope_theta=10000.0, **c["proj"])
    second = da.qkv_rope_projection(x2, c["w"], c["bias"], c["index"],
                                    rope_theta=10000.0, **c["proj"])
    for a, b in zip(first, second):
        assert torch.equal(a[0], b[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ["m64", "m72_k200"])
def test_qkv_rope_sim_arm_bitwise_at_steps_8(cuda, dtype, shape):
    """A full-precision weight with a scale row of ones gives the
    unquantized arm's bits, with and without a bias."""
    c = _k2_case(cuda, dtype, shape, 64, seed=4)
    ones = torch.ones(c["w"].shape[1], device=cuda)
    for b in (None, c["bias"]):
        plain = da.qkv_rope_projection(c["x"], c["w"], b, c["index"],
                                       rope_theta=10000.0, **c["proj"])
        sim = da.qkv_rope_projection(c["x"], c["w"], b, c["index"],
                                     rope_theta=10000.0, w_scale=ones,
                                     **c["proj"])
        for a, s in zip(plain, sim):
            assert torch.equal(a, s)


@pytest.mark.cuda
def test_qkv_rope_raises_on_what_it_does_not_take(cuda):
    """head_dim past 128, or not a whole 16-byte load of the weight,
    raises before any launch."""
    x = torch.zeros(2, 1, 64, dtype=torch.bfloat16, device=cuda)
    idx = torch.zeros(2, dtype=torch.int32, device=cuda)
    before = dict(da.LAUNCHES)
    with pytest.raises(ValueError, match="head_dim"):
        da.qkv_rope_projection(
            x, torch.zeros(64, 4 * 136, dtype=torch.bfloat16, device=cuda),
            None, idx, num_heads=2, kv_heads=1)
    with pytest.raises(ValueError, match="head_dim"):
        da.qkv_rope_projection(
            x, torch.zeros(64, 4 * 40, dtype=torch.int8, device=cuda), None,
            idx, num_heads=2, kv_heads=1,
            w_scale=torch.ones(4 * 40, device=cuda))
    assert da.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("steps", [1, 8])
def test_qkv_rope_long_splits_wrap_the_ring(cuda, dtype, int8, steps):
    """d_model 8192 over 40 heads of 64: each split is 13 k tiles, more
    than the stages of either ring, so every slot is reused."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    b, h, kvh, hd, dm = 8, 32, 4, 64, 8192
    k_per, ksplit, _ = da._qkv_geometry(dm, h + 2 * kvh, b * steps,
                                        da._sm_count(cuda.index or 0))
    assert k_per // 64 > 4
    w = (torch.randn(dm, (h + 2 * kvh) * hd, generator=gen, device=cuda)
         * 0.01).to(dtype)
    proj = dict(num_heads=h, kv_heads=kvh, rope_theta=10000.0)
    if int8:
        w, proj["w_scale"] = tlm.quantize_kernel(w)
    x = torch.randn(b, steps, dm, generator=gen, device=cuda).to(dtype)
    idx = torch.arange(b, device=cuda, dtype=torch.int32) * 100
    bias = (torch.randn((h + 2 * kvh) * hd, generator=gen, device=cuda)
            * 0.1).to(dtype)
    _k2_close(da.qkv_rope_projection(x, w, bias, idx, **proj),
              da.qkv_rope_reference(x, w, bias, idx, **proj), dtype)
