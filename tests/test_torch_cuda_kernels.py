"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here needs an NVIDIA GPU and `nvcc` (the kernels build at
first use); without one each skips, deciding inside the test. The file
imports neither jax nor the JAX package, so on a GPU machine without jax
it runs on its own:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -q

Tolerances: f32 cases differ only in summation order (1e-4 on O(1)
values); bf16 cases also round at other points (the plain attention
rounds probabilities to bf16 where the forward kernels keep them in f32;
the backward kernels round P and dS to bf16 for the tensor cores where
the plain backward keeps them in f32): a few bf16 ulps, 3e-2 on O(1)
values.
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

    table = (torch.randperm(nb - 1, generator=gen, device=dev) + 1)[: b * nlog]
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
    "d128": (1, 2, 96, 160, 128, True, 160),
    "d40": (1, 2, 77, 77, 40, False, 77),
    # The last tile narrower than one 16-row mma fragment; fewer keys
    # than one fragment; a long causal sequence at LM-training width; the
    # wide head at the ViT's length.
    "s17": (2, 2, 17, 17, 64, False, 17),
    "sk8_causal": (2, 2, 8, 8, 64, True, 8),
    "lm_causal": (1, 4, 1024, 1024, 64, True, 1024),
    "d128_s296": (1, 2, 296, 296, 128, False, 296),
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_forward_and_grad_match_plain(cuda, dtype):
    """K3 on the packed tensor as it lies (a column slice of a wider
    buffer, so rows are strided), and the packed backward (K4 recompute,
    K5 + K6 into the packed gradient) against the plain versions."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    b, s, h, d = 3, 296, 6, 64
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


@pytest.mark.cuda
@pytest.mark.parametrize("d, col0", [(64, 1), (36, 0), (128, 1)])
def test_backward_of_unaligned_rows_matches_plain(cuda, d, col0):
    """Rows whose start is not 16-byte aligned (views cut one column into
    a wider buffer) and rows of d * 2 bytes not a multiple of 16 take the
    kernels' per-element load path, at both head-width arms; bf16, causal
    with sq < sk."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    b, h, sq, sk = 2, 3, 90, 130

    def view(s):
        wide = torch.randn(b, h, s, d + 8, generator=gen, device=cuda)
        return wide.to(torch.bfloat16)[..., col0:col0 + d]

    q, k, v, g = view(sq), view(sk), view(sk), view(sq)
    out, lse = fa.flash_reference(q, k, v, causal=True)
    got = fa._flash_bwd_cuda(q, k, v, out, lse, g, None, True, sk)
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
    # One warm-up step, then one recorded step of one backward.
    events = []
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: events.extend(p.events())) as prof:
        for _ in range(2):
            fa.reset_launch_counts()
            fa._flash_bwd_cuda(*args)
            torch.cuda.synchronize()
            prof.step()
    assert fa.LAUNCHES == {
        "packed_attention": 0, "flash_fwd": 0, "flash_dq": 1, "flash_dkv": 1,
    }
    kernels = [
        e.name for e in sorted(events, key=lambda e: e.time_range.start)
        if e.device_type.name == "CUDA"
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
def test_dense_decode_attention_limits_raise(cuda):
    q, k, v = _dense_case(cuda, torch.float32, h=32, kvh=1, steps=8)
    with pytest.raises(ValueError, match="group \\* steps"):
        da.decode_attention(q, k, v, 10)
    q, k, v = _dense_case(cuda, torch.float32, hd=32)
    with pytest.raises(ValueError, match="head_dim"):
        da.decode_attention(q, k, v, 10)


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
