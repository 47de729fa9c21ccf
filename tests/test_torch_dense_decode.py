"""The port's dense-cache decode attention against the JAX package's.

`decode_attention_reference` and the port's `decode_attention` on CPU
tensors (its plain route) against JAX `decode_attention(...,
interpret=True)`, which runs the TPU kernel `_gqa_pallas` in interpret
mode, as tests/test_decode_stream.py does. Inputs come from numpy with
fixed seeds. Everything is f32, so the tolerance (2e-5 absolute and
relative) only absorbs summation order between two f32 implementations.

K7 itself (csrc/decode_attention.cu) cannot run on the CPU: the
`cuda`-marked tests in tests/test_torch_cuda_kernels.py hold it against
this plain version on a GPU.
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
HEADS, HD = 4, 16


def _case(kvh, steps, cache_len, b=5, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, HEADS, steps, HD)).astype(np.float32)
    k = rng.standard_normal((b, kvh, cache_len, HD)).astype(np.float32)
    v = rng.standard_normal((b, kvh, cache_len, HD)).astype(np.float32)
    return q, k, v


def _both(q, k, v, index):
    """(JAX kernel in interpret mode, port's plain version, port's
    wrapper on CPU tensors) on the same inputs."""
    want = np.asarray(jda.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(index),
        interpret=True,
    ))
    t = [torch.from_numpy(np.asarray(a)) for a in (q, k, v, index)]
    before = dict(tda.LAUNCHES)
    ref = tda.decode_attention_reference(*t)
    wrap = tda.decode_attention(*t)
    assert tda.LAUNCHES == before  # the CPU route launches no kernel
    return want, ref.numpy(), wrap.numpy()


@pytest.mark.parametrize("steps", [1, 3, 8])
@pytest.mark.parametrize("kvh", [1, 2, 4])
def test_per_row_index_matches_jax_kernel(kvh, steps):
    """Ragged rows: slot start, block edge -2/-1, the next block's first
    row, and one past the cache (every row visible)."""
    cache_len = 384 if (kvh + steps) % 2 else 256
    q, k, v = _case(kvh, steps, cache_len, seed=kvh * 10 + steps)
    index = np.asarray([0, 126, 127, 128, cache_len], np.int32)
    want, ref, wrap = _both(q, k, v, index)
    np.testing.assert_allclose(ref, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(wrap, ref)


@pytest.mark.parametrize("index", [0, 126, 127, 128, 256])
def test_scalar_index_matches_jax_kernel(index):
    q, k, v = _case(2, 3, 256, seed=index)
    want, ref, wrap = _both(q, k, v, np.int32(index))
    np.testing.assert_allclose(ref, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(wrap, ref)


@pytest.mark.parametrize("ragged", [False, True])
def test_single_query_layout(ragged):
    """3-d q (one decode step) comes back 3-d, as in JAX."""
    q, k, v = _case(2, 1, 384, seed=7)
    index = (
        np.asarray([5, 127, 128, 300, 383], np.int32) if ragged
        else np.int32(200)
    )
    want, ref, wrap = _both(q[:, :, 0], k, v, index)
    assert ref.shape == (5, HEADS, HD)
    np.testing.assert_allclose(ref, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(wrap, ref)


@pytest.mark.parametrize("ragged", [False, True])
def test_cache_len_off_the_128_grid(ragged):
    """cache_len % 128 != 0: JAX falls back to its reference there; the
    port's plain version (and K7 on the card) takes any length."""
    q, k, v = _case(4, 5, 200, seed=9)
    index = (
        np.asarray([0, 63, 64, 150, 200], np.int32) if ragged
        else np.int32(190)
    )
    want = np.asarray(jda.decode_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(index)
    ))
    got = tda.decode_attention(*(torch.from_numpy(np.asarray(a)) for a in (q, k, v, index)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_python_int_index_and_future_rows_masked():
    """An int index works like a 0-d tensor, and rows past index + r
    never reach the output (poisoning them changes nothing)."""
    q, k, v = _case(2, 4, 256, seed=11)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    base = tda.decode_attention(*t, 100)
    np.testing.assert_array_equal(
        base.numpy(), tda.decode_attention(*t, torch.tensor(100)).numpy()
    )
    k2, v2 = k.copy(), v.copy()
    k2[:, :, 104:] = 1e4
    v2[:, :, 104:] = -1e4
    got = tda.decode_attention(t[0], torch.from_numpy(k2), torch.from_numpy(v2), 100)
    np.testing.assert_array_equal(got.numpy(), base.numpy())
