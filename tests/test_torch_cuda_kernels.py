"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here needs an NVIDIA GPU and `nvcc` (the kernels build at
first use); without one each skips, deciding inside the test. The file
imports neither jax nor the JAX package, so on a GPU machine without jax
it runs on its own:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -q

Tolerances: f32 cases differ only in summation order (1e-4 on O(1)
values); bf16 cases also round at other points (the plain attention
rounds probabilities to bf16, the kernel keeps them in f32): a few bf16
ulps, 3e-2 on O(1) values.
"""

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
