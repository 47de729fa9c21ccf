"""The port's int8 storage arms against the JAX package's.

Row quantization, the quantizing scatter, the plain paged and fused
attention over int8 pools, `quantize_lm_params` and `QuantDense`: the
same numpy inputs from fixed seeds go through both sides. The JAX side
runs its Pallas kernels in interpret mode, as its own tests do
(tests/test_decode_stream.py, `TestQuantizedKernelParity`).

Tolerances: quantization and the scatter are held BITWISE (the same f32
division, round half to even and clip on both sides). Attention and
matrix products are f32 on both sides and differ only in summation
order: 2e-5, the tolerance of tests/test_torch_decode_attention.py. The
"sim" arms are held bitwise to the unquantized ones.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkai_nos_tpu.models import lm as jlm
from walkai_nos_tpu.ops import decode_attention as jda
from walkai_nos_tpu_torch.models import lm as tlm
from walkai_nos_tpu_torch.ops import decode_attention as tda

# Tiny shapes: one intra-op thread leaves the cores to the other test
# workers.
torch.set_num_threads(1)

ATOL = RTOL = 2e-5  # f32 vs f32, different reduction order
NB, NLOG, HD, HEADS = 20, 3, 16, 4
PAGE = tda.PAGE_ROWS
# Ragged indices: slot start, block edge -2/-1, inside block 1, and past
# the table's capacity (NLOG * 128 = 384).
INDEX = [0, 126, 127, 200, 400]


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return np.asarray(a.float() if a.dtype == torch.bfloat16 else a)


def _boundary_rows():
    """Rows whose scale is exactly 1.0 (amax 127), so their values sit on
    .5 rounding boundaries (round half to even: 2.5 -> 2, -3.5 -> -4),
    an all-zero row (the 1e-12 floor), and random rows."""
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((2, 3, 5, HD)).astype(np.float32)
    rows[0, 0, 0] = 0.0
    edge = np.array([127, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5]
                    + [0.25] * (HD - 8), np.float32)
    rows[0, 1, 2] = edge
    rows[1, 2, 4] = -edge
    return rows


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", ["int8", "sim"])
def test_quantize_kv_rows_bitwise(quant, dtype):
    rows = _boundary_rows()
    jrows = jnp.asarray(rows).astype(dtype)
    trows = _t(rows).to(getattr(torch, dtype))
    jq, js = jda.quantize_kv_rows(jrows, quant)
    tq, ts = tda.quantize_kv_rows(trows, quant)
    assert ts.dtype == torch.float32
    assert tq.dtype == (torch.int8 if quant == "int8" else trows.dtype)
    np.testing.assert_array_equal(_np(tq), np.asarray(jq, np.float32))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if quant == "int8":
        assert (ts[0, 0, 0] == 1e-12).item() and (tq[0, 0, 0] == 0).all()
        assert tq[0, 1, 2, :8].tolist() == [127, 2, -4, 0, 0, 2, 126, -126]


def _table(b=4, seed=3):
    """[b, NLOG] shuffled physical blocks (block 0, the scratch block,
    unused)."""
    rng = np.random.default_rng(seed)
    return rng.permutation(np.arange(1, NB))[:b * NLOG].reshape(b, NLOG)


@pytest.mark.parametrize("quant", ["int8", "sim"])
def test_scatter_quantizes_like_jax(quant):
    """Pools and scale pools bitwise equal to JAX's: a window crossing a
    block edge, one straddling the table's capacity and one wholly past
    it, whose rows and scales are both dropped."""
    rng = np.random.default_rng(7)
    kvh, steps = 2, 6
    table = _table().astype(np.int32)
    index = np.asarray([125, 380, 500, 0], np.int32)
    k = rng.standard_normal((4, kvh, steps, HD)).astype(np.float32)
    v = rng.standard_normal((4, kvh, steps, HD)).astype(np.float32)
    dtype = np.int8 if quant == "int8" else np.float32
    kp = rng.integers(-5, 5, (NB, kvh, PAGE, HD)).astype(dtype)
    vp = rng.integers(-5, 5, (NB, kvh, PAGE, HD)).astype(dtype)
    ksp = rng.random((NB, kvh, PAGE)).astype(np.float32)
    vsp = rng.random((NB, kvh, PAGE)).astype(np.float32)
    want = jda.scatter_paged_rows(
        *map(jnp.asarray, (kp, vp, k, v, table, index)),
        k_scale_pool=jnp.asarray(ksp), v_scale_pool=jnp.asarray(vsp),
        quant=quant,
    )
    kpd, vpd, kspd, vspd = (tda.with_dump_block(_t(a)) for a in (kp, vp, ksp, vsp))
    got = tda.scatter_paged_rows(
        kpd, vpd, *map(_t, (k, v, table, index)),
        k_scale_pool=kspd, v_scale_pool=vspd, quant=quant,
    )
    assert len(got) == 4
    for name, a, b in zip(("k", "v", "ks", "vs"), got, want):
        np.testing.assert_array_equal(a.numpy()[:-1], np.asarray(b), err_msg=name)
    # Slot 2 (index 500, past capacity 384) wrote nothing anywhere.
    for j in range(NLOG):
        blk = table[2, j]
        np.testing.assert_array_equal(got[2][blk].numpy(), ksp[blk])
        np.testing.assert_array_equal(got[0][blk].numpy(), kp[blk])


def _int8_pools(kvh, seed, quant="int8"):
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((NB, kvh, PAGE, HD)).astype(np.float32)
    vp = rng.standard_normal((NB, kvh, PAGE, HD)).astype(np.float32)
    kq, ks = jda.quantize_kv_rows(jnp.asarray(kp), quant)
    vq, vs = jda.quantize_kv_rows(jnp.asarray(vp), quant)
    return tuple(np.asarray(a) for a in (kq, vq, ks, vs))


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("kvh", [2, 4])  # GQA (4 heads on 2) and MHA
def test_paged_reference_over_int8_matches_jax_kernel(kvh, steps):
    kq, vq, ks, vs = _int8_pools(kvh, seed=kvh + steps)
    rng = np.random.default_rng(steps)
    q = rng.standard_normal((len(INDEX), HEADS, steps, HD)).astype(np.float32)
    table = _table(len(INDEX), seed=9).astype(np.int32)
    index = np.asarray(INDEX, np.int32)
    want = jda.paged_decode_attention(
        *map(jnp.asarray, (q, kq, vq, table, index)),
        k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs), interpret=True,
    )
    before = dict(tda.LAUNCHES)
    got = tda.paged_decode_attention(
        *map(_t, (q, kq, vq, table, index)), k_scales=_t(ks), v_scales=_t(vs)
    )
    assert tda.LAUNCHES == before  # the CPU path launches no kernel
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_sim_scales_equal_unquantized_plain_bitwise():
    """Full-precision pools with unit scales (the "sim" arm) give the
    unquantized plain version's output bit for bit, and the dequantized
    view is the plain gathered one."""
    rng = np.random.default_rng(4)
    q = _t(rng.standard_normal((len(INDEX), HEADS, 3, HD)).astype(np.float32))
    kp = _t(rng.standard_normal((NB, 2, PAGE, HD)).astype(np.float32))
    vp = _t(rng.standard_normal((NB, 2, PAGE, HD)).astype(np.float32))
    table = _t(_table(len(INDEX)).astype(np.int32))
    index = _t(np.asarray(INDEX, np.int32))
    ones = torch.ones(NB, 2, PAGE)
    plain = tda.paged_decode_attention(q, kp, vp, table, index)
    sim = tda.paged_decode_attention(
        q, kp, vp, table, index, k_scales=ones, v_scales=ones
    )
    np.testing.assert_array_equal(sim.numpy(), plain.numpy())
    np.testing.assert_array_equal(
        tda.dequantize_gathered(kp, ones, table, torch.float32).numpy(),
        tda.gather_paged_cache(kp, table).numpy(),
    )


def _fused_int8_case(seed, kvh=2, steps=4, b=3):
    rng = np.random.default_rng(seed)
    dm = HEADS * HD
    dout = dm + 2 * kvh * HD
    x = rng.standard_normal((b, steps, dm)).astype(np.float32)
    w = rng.standard_normal((dm, dout)) * 0.1
    w_scale = np.maximum(np.abs(w).max(axis=0) / 127, 1e-12).astype(np.float32)
    wq = np.clip(np.round(w / w_scale), -127, 127).astype(np.int8)
    bias = (rng.standard_normal(dout) * 0.1).astype(np.float32)
    kq, vq, ks, vs = _int8_pools(kvh, seed + 1)
    table = rng.permutation(np.arange(1, NB))[:b * NLOG].reshape(b, NLOG)
    index = np.asarray([0, 126, 381][:b], np.int32)  # 381: past capacity
    return x, wq, bias, kq, vq, table.astype(np.int32), index, w_scale, ks, vs


@pytest.mark.parametrize("rope", [False, True])
def test_fused_reference_int8_matches_jax_kernel(rope):
    """int8 weight + scale row, int8 pools + scale pools: the plain fused
    version against the JAX fused kernel in interpret mode."""
    x, wq, bias, kq, vq, table, index, w_scale, ks, vs = _fused_int8_case(3)
    theta = 10000.0 if rope else None
    want = jda.fused_qkv_paged_attention(
        *map(jnp.asarray, (x, wq, bias, kq, vq, table, index)),
        num_heads=HEADS, rope_theta=theta, w_scale=jnp.asarray(w_scale),
        k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs), interpret=True,
    )
    kq_t = _t(kq.copy())
    got = tda.fused_qkv_paged_attention(
        *map(_t, (x, wq, bias)), kq_t, *map(_t, (vq, table, index)),
        num_heads=HEADS, rope_theta=theta, w_scale=_t(w_scale),
        k_scales=_t(ks), v_scales=_t(vs),
    )
    for name, a, b in zip(("o", "k_new", "v_new"), got, want):
        np.testing.assert_allclose(
            a.numpy(), np.asarray(b), atol=ATOL, rtol=RTOL, err_msg=name
        )
    np.testing.assert_array_equal(kq_t.numpy(), kq)  # pools untouched
    # K2's plain version gives the same fresh rows.
    _, k_new, v_new = tda.qkv_rope_projection(
        *map(_t, (x, wq, bias, index)), num_heads=HEADS, kv_heads=2,
        rope_theta=theta, w_scale=_t(w_scale),
    )
    np.testing.assert_allclose(k_new.numpy(), got[1].numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(v_new.numpy(), got[2].numpy(), atol=ATOL, rtol=RTOL)


def test_fused_fresh_rows_ignore_poisoned_scales():
    """The fresh rows attend at full precision: scale pools poisoned at
    every write position leave the plain fused output unchanged, bit for
    bit, as in the JAX kernel."""
    x, wq, bias, kq, vq, table, index, w_scale, ks, vs = _fused_int8_case(6)
    pks, pvs = ks.copy(), vs.copy()
    cap = NLOG * PAGE
    for s in range(len(index)):
        for t in range(x.shape[1]):
            pos = int(index[s]) + t
            if pos < cap:
                blk = table[s, pos // PAGE]
                pks[blk, :, pos % PAGE] = 1e6
                pvs[blk, :, pos % PAGE] = 1e6
    outs = [
        tda.fused_qkv_paged_attention(
            *map(_t, (x, wq, bias, kq, vq, table, index)), num_heads=HEADS,
            rope_theta=10000.0, w_scale=_t(w_scale), k_scales=_t(a),
            v_scales=_t(b),
        )
        for a, b in ((ks, vs), (pks, pvs))
    ]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


LM_FIELDS = dict(
    vocab_size=64, hidden_dim=32, num_layers=2, num_heads=2,
    num_kv_heads=1, mlp_dim=48, max_seq_len=256, dtype="float32",
    norm="rmsnorm", mlp="swiglu", rope=True,
)


@pytest.fixture(scope="module")
def flax_params():
    cfg = jlm.LMConfig(**LM_FIELDS)
    params = jax.device_get(jlm.DecoderLM(cfg).init_params(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(1)
    return jax.tree.map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32),
        params,
    )


@pytest.mark.parametrize("w_dtype", ["int8", "int8-sim"])
def test_quantize_lm_params_bitwise_and_idempotent(flax_params, w_dtype):
    jcfg = jlm.LMConfig(**LM_FIELDS, w_dtype=w_dtype)
    tcfg = tlm.LMConfig(**LM_FIELDS, w_dtype=w_dtype)
    want = jax.device_get(jlm.quantize_lm_params(flax_params, jcfg))
    got = tlm.quantize_lm_params(flax_params, tcfg)
    jl = jax.tree_util.tree_leaves_with_path(want)
    tl = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=str(path))
    again = tlm.quantize_lm_params(got, tcfg)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(again)):
        np.testing.assert_array_equal(a, b)
    # The caller's tree is left as it was.
    assert "scale" not in flax_params["block0"]["attn"]["qkv"]
    # And the quantized tree loads into the port's quantized model.
    model = tlm.DecoderLM.from_params(tcfg, got, device="cpu")
    qkv = model.blocks[0].attn.qkv
    assert qkv.kernel.dtype == (torch.int8 if w_dtype == "int8" else torch.float32)
    np.testing.assert_array_equal(
        qkv.scale.numpy(), got["block0"]["attn"]["qkv"]["scale"]
    )


def _quant_dense(params, sim, dtype=torch.float32):
    d_in, d_out = params["kernel"].shape
    layer = tlm.QuantDense(
        d_in, d_out, bias=True, dtype=dtype, device="cpu",
        gen=torch.Generator().manual_seed(0), sim=sim,
    )
    with torch.no_grad():
        layer.kernel.copy_(_t(np.asarray(params["kernel"])).to(layer.kernel.dtype))
        layer.scale.copy_(_t(np.asarray(params["scale"])))
        layer.bias.copy_(_t(np.asarray(params["bias"])).to(dtype))
    return layer


def test_quant_dense_int8_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    w = rng.standard_normal((32, 24)).astype(np.float32)
    q, scale = tlm.quantize_kernel(_t(w))
    params = {"kernel": q.numpy(), "scale": scale.numpy(),
              "bias": (rng.standard_normal(24) * 0.1).astype(np.float32)}
    want = jlm.QuantDense(24, dtype=jnp.float32, use_bias=True).apply(
        {"params": jax.tree.map(jnp.asarray, params)}, jnp.asarray(x)
    )
    got = _quant_dense(params, sim=False)(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_quant_dense_sim_bitwise_dense():
    """bf16: QuantDense's sim arm equals `Dense` on the same kernel and
    bias bit for bit (the f32 multiply by 1.0 and the round trip are
    exact), as JAX's sim QuantDense equals nn.Dense."""
    rng = np.random.default_rng(5)
    x = _t(rng.standard_normal((4, 32)).astype(np.float32)).to(torch.bfloat16)
    params = {"kernel": rng.standard_normal((32, 16)).astype(np.float32),
              "scale": np.ones(16, np.float32),
              "bias": rng.standard_normal(16).astype(np.float32)}
    sim = _quant_dense(params, sim=True, dtype=torch.bfloat16)
    dense = tlm.Dense(32, 16, bias=True, dtype=torch.bfloat16, device="cpu",
                      gen=torch.Generator().manual_seed(0))
    with torch.no_grad():
        dense.kernel.copy_(sim.kernel)
        dense.bias.copy_(sim.bias)
    np.testing.assert_array_equal(_np(sim(x)), _np(dense(x)))
    # JAX's flax Dense on the same bf16 values agrees within bf16 rounding.
    jd = nn.Dense(16, dtype=jnp.bfloat16).apply(
        {"params": {"kernel": jnp.asarray(_np(sim.kernel)),
                    "bias": jnp.asarray(_np(sim.bias))}},
        jnp.asarray(_np(x)).astype(jnp.bfloat16),
    )
    np.testing.assert_allclose(
        _np(sim(x)), np.asarray(jd, np.float32), atol=2e-2, rtol=2e-2
    )


def test_random_int8_model_quantizes_the_full_precision_draws():
    """`DecoderLM(cfg, seed)` with w_dtype="int8" holds the quantization
    of the weights the full-precision model of the same seed draws."""
    base = tlm.DecoderLM(tlm.LMConfig(**LM_FIELDS), device="cpu", seed=3)
    q8 = tlm.DecoderLM(tlm.LMConfig(**LM_FIELDS, w_dtype="int8"),
                       device="cpu", seed=3)
    for name in ("attn.qkv", "attn.out_proj", "gate", "fc1", "fc2"):
        full = base.blocks[1].get_submodule(name)
        quant = q8.blocks[1].get_submodule(name)
        kq, scale = tlm.quantize_kernel(full.kernel)
        assert torch.equal(quant.kernel, kq) and torch.equal(quant.scale, scale)
    assert torch.equal(base.head.kernel, q8.head.kernel)
