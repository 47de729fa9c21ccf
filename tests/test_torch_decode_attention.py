"""The port's decode-attention functions against the JAX package.

Inputs come from numpy with fixed seeds and go through both sides. The
JAX side runs its Pallas kernels in interpret mode, as its own tests do
(tests/test_decode_stream.py). Everything is f32 here, so the tolerance
(2e-5) only absorbs summation order between two f32 implementations.

The CUDA kernels themselves cannot run on the CPU: the `cuda`-marked
tests in tests/test_torch_cuda_kernels.py hold them against these plain
versions on a GPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkai_nos_tpu.ops import decode_attention as jda
from walkai_nos_tpu_torch.ops import decode_attention as tda

# Tiny shapes: one intra-op thread leaves the cores to the other test
# workers.
torch.set_num_threads(1)

ATOL = RTOL = 2e-5  # f32 vs f32, different reduction order
NB, NLOG, HD, HEADS = 20, 3, 16, 4
# Ragged indices: slot start, block edge -2/-1, inside block 1, and past
# the table's capacity (NLOG * 128 = 384), where every row is visible.
INDEX = [0, 126, 127, 200, 400]


def _pool_case(kvh, steps, seed=0, b=len(INDEX)):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, HEADS, steps, HD)).astype(np.float32)
    kp = rng.standard_normal((NB, kvh, 128, HD)).astype(np.float32)
    vp = rng.standard_normal((NB, kvh, 128, HD)).astype(np.float32)
    # Shuffled table, physical != logical, block 0 unused.
    table = rng.permutation(np.arange(1, NB))[:b * NLOG].reshape(b, NLOG)
    return q, kp, vp, table.astype(np.int32), np.asarray(INDEX[:b], np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("steps", [1, 4, 8])
@pytest.mark.parametrize("kvh", [1, 2, 4])
def test_paged_reference_matches_jax_kernel(kvh, steps):
    q, kp, vp, table, index = _pool_case(kvh, steps, seed=kvh * 10 + steps)
    want = jda.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(index), interpret=True,
    )
    got = tda.paged_decode_attention_reference(
        _t(q), _t(kp), _t(vp), _t(table), _t(index)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_single_query_layout_and_cpu_wrapper():
    """3-d q (the serving step) and the CPU wrapper route to the plain
    version with the JAX function's shapes."""
    q, kp, vp, table, index = _pool_case(2, 1, seed=3)
    want = jda.paged_decode_attention(
        jnp.asarray(q[:, :, 0]), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(index), interpret=True,
    )
    before = dict(tda.LAUNCHES)
    got = tda.paged_decode_attention(
        _t(q[:, :, 0]), _t(kp), _t(vp), _t(table), _t(index)
    )
    assert got.shape == (len(INDEX), HEADS, HD)
    assert tda.LAUNCHES == before  # the CPU path launches no kernel
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_unreferenced_blocks_never_leak():
    """Poisoning every pool block the tables do not reference, and the
    rows past each slot's visible range, leaves the output unchanged."""
    q, kp, vp, table, index = _pool_case(2, 4, seed=5, b=4)
    base = tda.paged_decode_attention_reference(
        _t(q), _t(kp), _t(vp), _t(table), _t(index)
    )
    kp2, vp2 = kp.copy(), vp.copy()
    unused = sorted(set(range(NB)) - set(table.reshape(-1).tolist()))
    assert unused
    kp2[unused] = 1e4
    vp2[unused] = -1e4
    for s in range(table.shape[0]):
        last = int(index[s]) + 3  # highest visible position
        for j in range(NLOG):
            lo = max(0, last + 1 - j * 128)
            if lo < 128:
                kp2[table[s, j], :, lo:] = 1e4
                vp2[table[s, j], :, lo:] = -1e4
    got = tda.paged_decode_attention_reference(
        _t(q), _t(kp2), _t(vp2), _t(table), _t(index)
    )
    np.testing.assert_array_equal(got.numpy(), base.numpy())


def test_scatter_drops_rows_past_capacity():
    """Rows at positions >= nlog * 128 are dropped, never clipped into
    the last block; the pools match the JAX scatter exactly."""
    rng = np.random.default_rng(7)
    kvh, steps = 2, 8
    kp = rng.standard_normal((NB, kvh, 128, HD)).astype(np.float32)
    vp = rng.standard_normal((NB, kvh, 128, HD)).astype(np.float32)
    table = rng.permutation(np.arange(1, NB))[:3 * NLOG].reshape(3, NLOG)
    table = table.astype(np.int32)
    # Crosses a block edge; straddles capacity (380..387); fully past.
    index = np.asarray([124, 380, 500], np.int32)
    k = rng.standard_normal((3, kvh, steps, HD)).astype(np.float32)
    v = rng.standard_normal((3, kvh, steps, HD)).astype(np.float32)
    jk, jv = jda.scatter_paged_rows(
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(table), jnp.asarray(index),
    )
    tk, tv = tda.scatter_paged_rows(
        tda.with_dump_block(_t(kp)), tda.with_dump_block(_t(vp)), _t(k), _t(v),
        _t(table), _t(index),
    )
    np.testing.assert_array_equal(tk.numpy()[:-1], np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy()[:-1], np.asarray(jv))
    # Slot 1's last block keeps its rows 124..127 from before: only
    # positions 380..383 landed; slot 2 wrote nothing at all.
    last = table[1, NLOG - 1]
    np.testing.assert_array_equal(tk.numpy()[last, :, :124], kp[last, :, :124])
    for j in range(NLOG):
        np.testing.assert_array_equal(
            tk.numpy()[table[2, j]], kp[table[2, j]]
        )


def test_scatter_duplicate_locations_take_the_last_writer():
    """Slots parked on the scratch block 0 write the same rows of it with
    different values, beside a slot whose rows straddle capacity: each
    location holds its last writer in row order, as JAX's scatter leaves
    it, and the dropped rows land only in the dump block."""
    rng = np.random.default_rng(3)
    kvh, steps = 2, 8
    kp = rng.standard_normal((NB, kvh, 128, HD)).astype(np.float32)
    vp = rng.standard_normal((NB, kvh, 128, HD)).astype(np.float32)
    table = np.asarray([[0] * NLOG, [1, 2, 3], [0] * NLOG, [0] * NLOG], np.int32)
    index = np.asarray([0, 380, 4, 0], np.int32)
    k = rng.standard_normal((4, kvh, steps, HD)).astype(np.float32)
    v = rng.standard_normal((4, kvh, steps, HD)).astype(np.float32)
    jk, jv = jda.scatter_paged_rows(
        *map(jnp.asarray, (kp, vp, k, v, table, index))
    )
    tk, tv = tda.scatter_paged_rows(
        tda.with_dump_block(_t(kp)), tda.with_dump_block(_t(vp)), _t(k), _t(v),
        _t(table), _t(index),
    )
    np.testing.assert_array_equal(tk.numpy()[:-1], np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy()[:-1], np.asarray(jv))
    # Row 4 of block 0: slots 0, 2 and 3 write it; slot 3 is the last.
    np.testing.assert_array_equal(tk.numpy()[0, :, 4], k[3, :, 4])
    np.testing.assert_array_equal(tk.numpy()[0, :, 11], k[2, :, 7])


def _fused_case(kvh, steps, seed, b=len(INDEX)):
    rng = np.random.default_rng(seed)
    dm = HEADS * HD
    dout = dm + 2 * kvh * HD
    x = rng.standard_normal((b, steps, dm)).astype(np.float32)
    w = (rng.standard_normal((dm, dout)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal(dout) * 0.1).astype(np.float32)
    _, kp, vp, table, index = _pool_case(kvh, steps, seed=seed + 1, b=b)
    return x, w, bias, kp, vp, table, index


@pytest.mark.parametrize(
    "kvh,steps,rope",
    [(kvh, 4, rope) for kvh in (1, 2, 4) for rope in (False, True)]
    + [(4, 1, True), (2, 8, True), (1, 8, False)],
)
def test_fused_reference_matches_jax_kernel(kvh, steps, rope):
    x, w, bias, kp, vp, table, index = _fused_case(kvh, steps, seed=kvh + steps)
    theta = 10000.0 if rope else None
    want = jda.fused_qkv_paged_attention(
        *map(jnp.asarray, (x, w, bias, kp, vp, table, index)),
        num_heads=HEADS, rope_theta=theta, interpret=True,
    )
    got = tda.fused_qkv_paged_reference(
        *map(_t, (x, w, bias, kp, vp, table, index)),
        num_heads=HEADS, rope_theta=theta,
    )
    for name, a, b in zip(("o", "k_new", "v_new"), got, want):
        np.testing.assert_allclose(
            a.numpy(), np.asarray(b), atol=ATOL, rtol=RTOL, err_msg=name
        )
    # The CPU wrapper is the plain version and leaves the pools alone.
    kp_t = _t(kp.copy())
    wrap = tda.fused_qkv_paged_attention(
        _t(x), _t(w), _t(bias), kp_t, _t(vp), _t(table), _t(index),
        num_heads=HEADS, rope_theta=theta,
    )
    np.testing.assert_array_equal(wrap[0].numpy(), got[0].numpy())
    np.testing.assert_array_equal(kp_t.numpy(), kp)


@pytest.mark.parametrize("rope", [False, True])
def test_qkv_rope_reference_matches_jax_fresh_rows(rope):
    """K2's plain version (f32 projection + bias, then rotary) gives the
    JAX fused kernel's k_new / v_new and the query the attention uses."""
    x, w, bias, kp, vp, table, index = _fused_case(2, 4, seed=11)
    theta = 10000.0 if rope else None
    _, k_j, v_j = jda.fused_qkv_paged_attention(
        *map(jnp.asarray, (x, w, bias, kp, vp, table, index)),
        num_heads=HEADS, rope_theta=theta, interpret=True,
    )
    q, k, v = tda.qkv_rope_projection(
        _t(x), _t(w), _t(bias), _t(index),
        num_heads=HEADS, kv_heads=2, rope_theta=theta,
    )
    assert q.shape == (len(INDEX), HEADS, 4, HD)
    np.testing.assert_allclose(k.numpy(), np.asarray(k_j), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), atol=ATOL, rtol=RTOL)


def test_int8_pool_without_scales_raises():
    """No fallback for a quantized pool or weight: an int8 pool without
    its scale pools, one scale pool alone, or an int8 weight without its
    scale row raises instead of being read as plain numbers."""
    q, kp, vp, table, index = _pool_case(2, 1, seed=1)
    k8, v8 = _t(kp).to(torch.int8), _t(vp).to(torch.int8)
    with pytest.raises(ValueError, match="scale"):
        tda.paged_decode_attention(_t(q), k8, v8, _t(table), _t(index))
    with pytest.raises(ValueError, match="go together"):
        tda.paged_decode_attention(
            _t(q), k8, v8, _t(table), _t(index), k_scales=torch.ones(NB, 2, 128)
        )
    x, w, bias, kp, vp, table, index = _fused_case(2, 1, seed=1)
    with pytest.raises(ValueError, match="w_scale"):
        tda.fused_qkv_paged_attention(
            _t(x), _t(w).to(torch.int8), _t(bias), _t(kp), _t(vp), _t(table),
            _t(index), num_heads=HEADS,
        )
