"""The port's streamed wide-prefill tail (`ops/sp_prefill.py`) against
the JAX package's `streamed_cache_attention` and dense tail, on the CPU.

The same numpy inputs (seeded) go through both functions: ragged
per-row indices, GQA and MHA, a cache length that is no multiple of the
tile, and tiles of several widths, within 1e-5 in f32. The tiles the
port visits (its host horizon) change nothing, bit for bit. The port's
wide paged tail is the dense one JAX's CPU route takes, and what the
cache holds past a row's query positions changes none of its logits.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkai_nos_tpu.models import lm as jlm
from walkai_nos_tpu.ops import sp_prefill as jsp
from walkai_nos_tpu_torch.models import lm as tlm
from walkai_nos_tpu_torch.ops import decode_attention as tda
from walkai_nos_tpu_torch.ops import sp_prefill as tsp

torch.set_num_threads(1)

TOL = 1e-5


def _inputs(batch, heads, kv_heads, steps, cache_len, hd, idx, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((batch, heads, steps, hd)).astype(np.float32)
    k = rng.standard_normal((batch, kv_heads, cache_len, hd)).astype(np.float32)
    v = rng.standard_normal((batch, kv_heads, cache_len, hd)).astype(np.float32)
    return q, k, v, np.asarray(idx, np.int32)


CASES = {
    # batch, heads, kv_heads, steps, cache_len, head_dim, idx, tile
    "gqa-ragged": (3, 4, 2, 16, 384, 16, [0, 100, 360], 128),
    "mha": (2, 4, 4, 12, 256, 8, [5, 200], 128),
    "cache-not-tile-multiple": (2, 4, 2, 10, 300, 16, [0, 280], 128),
    "small-tile": (2, 8, 2, 9, 200, 16, [3, 150], 32),
    "tile-capped-at-cache": (2, 2, 1, 9, 64, 16, [0, 40], 512),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_streamed_matches_jax(case):
    b, h, kvh, steps, n, hd, idx, tile = CASES[case]
    q, k, v, ix = _inputs(b, h, kvh, steps, n, hd, idx)
    want = np.asarray(jsp.streamed_cache_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(ix),
        tile=tile,
    ))
    got = tsp.streamed_cache_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(ix), tile=tile,
    ).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_visited_tiles_change_nothing(case):
    """Tiles past a row's horizon fold as exact no-ops: the CPU's own
    horizon, every tile, and any horizon past the largest query position
    give the same bits."""
    b, h, kvh, steps, n, hd, idx, tile = CASES[case]
    args = [torch.from_numpy(a) for a in _inputs(b, h, kvh, steps, n, hd, idx)]
    own = tsp.streamed_cache_attention(*args, tile=tile)
    top = max(idx) + steps - 1
    for horizon in (top, top + 1, top + tile, n + tile * 4):
        other = tsp.streamed_cache_attention(*args, tile=tile, horizon=horizon)
        assert torch.equal(own, other), horizon


def test_streamed_bf16_close_to_dense_tail():
    """bf16 in, f32 scores and accumulator: within the dense tail's
    rounding of its probabilities."""
    q, k, v, ix = _inputs(2, 8, 2, 64, 512, 64, [0, 400], seed=3)
    args = [torch.from_numpy(a).bfloat16() for a in (q, k, v)]
    got = tsp.streamed_cache_attention(*args, torch.from_numpy(ix))
    want = tlm._masked_cache_attention(*args, torch.from_numpy(ix))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=2e-2, rtol=0)


FIELDS = dict(vocab_size=64, hidden_dim=64, num_layers=1, num_heads=4,
              num_kv_heads=2, mlp_dim=128, max_seq_len=512, dtype="float32",
              norm="rmsnorm", mlp="swiglu", rope=True, use_bias=False,
              head_bias=False)


def test_cpu_wide_tail_is_jax_dense_tail():
    """On the CPU the port's wide paged chunk (scatter, gather, dense
    masked attention) equals JAX's `_masked_cache_attention` over the
    same gathered view."""
    rng = np.random.default_rng(7)
    b, kvh, h, hd, steps, nlog, blocks = 2, 2, 4, 16, 24, 3, 8
    pool_k = rng.standard_normal((blocks, kvh, 128, hd)).astype(np.float32)
    pool_v = rng.standard_normal((blocks, kvh, 128, hd)).astype(np.float32)
    table = np.asarray([[3, 5, 1], [2, 7, 4]], np.int32)
    idx = np.asarray([100, 250], np.int32)
    q = rng.standard_normal((b, h, steps, hd)).astype(np.float32)
    want = np.asarray(jlm._masked_cache_attention(
        jnp.asarray(q),
        jnp.asarray(pool_k[table].transpose(0, 2, 1, 3, 4).reshape(b, kvh, -1, hd)),
        jnp.asarray(pool_v[table].transpose(0, 2, 1, 3, 4).reshape(b, kvh, -1, hd)),
        jnp.asarray(idx), True,
    ))
    k_all = tda.gather_paged_cache(torch.from_numpy(pool_k), torch.from_numpy(table))
    v_all = tda.gather_paged_cache(torch.from_numpy(pool_v), torch.from_numpy(table))
    got = tlm._masked_cache_attention(torch.from_numpy(q), k_all, v_all,
                                      torch.from_numpy(idx)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert k_all.shape[2] == nlog * 128


def test_wide_chunk_ignores_future_cache_rows():
    """A paged forward over a wide chunk: what the cache holds past each
    row's last query position weighs an exact zero, so junk written there
    (as the sp fan-out writes a prompt's later windows in the same
    dispatch) changes no logit, bit for bit."""
    cfg = dataclasses.replace(
        tlm.LMConfig(**FIELDS), paged_decode=True, ragged_decode=True,
        paged_blocks=8, cache_len=384,
    )
    model = tlm.DecoderLM(cfg, device="cpu", seed=0)
    tok = torch.randint(0, 64, (2, 16), generator=torch.Generator().manual_seed(1))
    table = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
    start = torch.tensor([0, 130], dtype=torch.int32)
    outs = []
    for junk in (False, True):
        cache = tlm.PagedCache.zeros(cfg, torch.device("cpu"))
        if junk:
            g = torch.Generator().manual_seed(2)
            for pool in (cache.k[0], cache.v[0]):
                # Row 0 queries up to 15 (block 1), row 1 up to 145
                # (block 5 holds 128..255): fill both past their ends.
                pool[1, :, 16:] = torch.randn(pool[1, :, 16:].shape, generator=g)
                pool[5, :, 18:] = torch.randn(pool[5, :, 18:].shape, generator=g)
                pool[[2, 3, 6]] = torch.randn(pool[[2, 3, 6]].shape, generator=g)
        outs.append(model(tok, cache, table, start))
    assert torch.equal(outs[0], outs[1])
