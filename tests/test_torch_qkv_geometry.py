"""K2's split of the k dimension (`_qkv_geometry`), on the CPU.

The QKV kernel (csrc/qkv_rope.cu) gives each CTA one head's columns, up
to 64 rows and one split of d_model; the splits are added in split order
by each head's last CTA. The split is a pure function of the shapes and
the SM count, so these properties hold without a GPU.
"""

import inspect

import pytest

from walkai_nos_tpu_torch.ops import decode_attention as da

D_MODELS = (8, 64, 200, 1000, 2048, 4096, 5120, 8192)
HEADS = (3, 12, 40, 96)
ROWS = (1, 8, 64, 72, 512)
SM_COUNTS = (1, 78, 132, 144)


def _cases():
    for dm in D_MODELS:
        for heads in HEADS:
            for rows in ROWS:
                yield dm, heads, rows


def _ranges(dm, k_per, ksplit):
    return [(z * k_per, min(dm, (z + 1) * k_per)) for z in range(ksplit)]


@pytest.mark.parametrize("sms", SM_COUNTS)
def test_splits_cover_d_model_exactly_with_none_empty(sms):
    for dm, heads, rows in _cases():
        k_per, ksplit, _ = da._qkv_geometry(dm, heads, rows, sms)
        spans = _ranges(dm, k_per, ksplit)
        assert spans[0][0] == 0 and spans[-1][1] == dm
        for (b0, e0), (b1, _) in zip(spans, spans[1:]):
            assert e0 == b1
        assert all(e > b for b, e in spans), (dm, heads, rows, sms)


@pytest.mark.parametrize("sms", SM_COUNTS)
def test_each_split_but_the_last_is_whole_k_tiles(sms):
    for dm, heads, rows in _cases():
        k_per, ksplit, _ = da._qkv_geometry(dm, heads, rows, sms)
        assert k_per % da._QKV_K_TILE == 0
        for b, e in _ranges(dm, k_per, ksplit)[:-1]:
            assert (e - b) % da._QKV_K_TILE == 0


@pytest.mark.parametrize("sms", SM_COUNTS)
def test_split_count_and_row_blocks_stay_in_range(sms):
    for dm, heads, rows in _cases():
        _, ksplit, mblocks = da._qkv_geometry(dm, heads, rows, sms)
        assert 1 <= ksplit <= da._QKV_MAX_SPLITS
        assert ksplit <= -(-dm // da._QKV_K_TILE)
        assert mblocks == -(-rows // da._QKV_ROWS)


@pytest.mark.parametrize("sms", SM_COUNTS)
def test_geometry_is_a_function_of_shapes_and_sm_count(sms):
    """Only integers go in (no tensor, no device query), and the same
    integers give the same split every time."""
    params = list(inspect.signature(da._qkv_geometry).parameters)
    assert params == ["d_model", "heads", "rows", "sm_count"]
    for dm, heads, rows in _cases():
        first = da._qkv_geometry(dm, heads, rows, sms)
        assert all(isinstance(v, int) for v in first)
        assert da._qkv_geometry(dm, heads, rows, sms) == first


def test_tinyllama_decode_step_fills_the_card():
    """TinyLlama-1.1B (d_model 2048, 32 + 2 x 4 heads of 64) at 8 decode
    rows on 132 SMs: 8 splits of 256 k rows, 320 CTAs."""
    assert da._qkv_geometry(2048, 40, 8, 132) == (256, 8, 1)
    assert da._qkv_geometry(2048, 40, 64, 132) == (256, 8, 1)
    assert da._qkv_geometry(2048, 40, 72, 132) == (448, 5, 2)
