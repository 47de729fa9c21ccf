"""The port's attention ops (`walkai_nos_tpu_torch/ops/attention.py`)
against the JAX package's, on the same numpy inputs.

The JAX side runs its Pallas kernels in interpret mode, as its own tests
do; the port runs the plain versions its wrappers take for CPU tensors,
through the same autograd structure the CUDA kernels sit in. f32 on both
sides, so values differ only in summation order:
- forward outputs and lse: max |port - jax| <= 1e-5;
- gradients: max |port - jax| <= 1e-4 * max |jax| + 1e-5 per tensor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkai_nos_tpu.ops import attention as jattn
from walkai_nos_tpu_torch.ops import attention as tattn

torch.set_num_threads(1)

FWD_TOL = 1e-5
GRAD_REL, GRAD_ABS = 1e-4, 1e-5

# (causal, sq, sk, kv_len, head_dim): the JAX kernel runs with 16-row
# blocks where the lengths allow, so causal block skipping and the kv_len
# tail skip are exercised; lengths that 16 does not divide (the edges the
# CUDA kernels mask: a tile narrower than one 16-row fragment, fewer keys
# than one fragment) run as one full-length block. The head widths the
# kernels zero-pad (40 in a 64-wide tile) or take whole (128).
CASES = {
    "full": (False, 48, 48, 48, 32),
    "causal": (True, 48, 48, 48, 32),
    "causal_sq_lt_sk": (True, 32, 64, 64, 32),
    "kv_tail": (False, 48, 64, 37, 32),
    "causal_kv_tail": (True, 64, 64, 50, 32),
    "s17": (False, 17, 17, 17, 32),
    "s8_causal": (True, 8, 8, 8, 32),
    "d40": (False, 48, 48, 48, 40),
    "d128_causal": (True, 32, 32, 32, 128),
}


def _blocks(sq, sk):
    """The JAX kernel's (block_q, block_k) for a case."""
    return (16, 16) if sq % 16 == 0 and sk % 16 == 0 else (sq, sk)


def _qkv(sq, sk, kv_len, *, b=2, h=2, d=32, seed=0, scale=1.0):
    """q, k, v as numpy f32; rows of k/v at or past kv_len are zero (the
    JAX kernel's kv_len contract)."""
    rng = np.random.default_rng(seed)
    q = scale * rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, h, sk, d)).astype(np.float32)
    k[:, :, kv_len:] = 0
    v[:, :, kv_len:] = 0
    return q, k, v


def _t(*arrays, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrays]


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def _assert_grads(got, want):
    for g, w, name in zip(got, want, "qkv"):
        w = np.asarray(w)
        assert np.all(np.isfinite(g)), name
        tol = GRAD_REL * float(np.max(np.abs(w))) + GRAD_ABS
        assert _max_err(g, w) <= tol, (name, _max_err(g, w), tol)


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_forward_and_lse_match_pallas(case):
    causal, sq, sk, kv_len, d = CASES[case]
    q, k, v = _qkv(sq, sk, kv_len, d=d, seed=1)
    jo, jl = jattn._flash_pallas_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
        *_blocks(sq, sk), True, kv_len,
    )
    to, tl = tattn.flash_reference(*_t(q, k, v), causal=causal, kv_len=kv_len)
    assert _max_err(to, jo) <= FWD_TOL
    assert _max_err(tl, jl) <= FWD_TOL
    # The public autograd path gives the same forward on the CPU.
    po = tattn.flash_attention(*_t(q, k, v), causal=causal, kv_len=kv_len)
    assert _max_err(po.detach(), jo) <= FWD_TOL


def test_causal_rows_that_see_no_key_take_the_reference_mean():
    """causal with sq > sk (the edge the JAX wrapper defers to its
    reference): rows that see no key get the mean of V over all keys."""
    q, k, v = _qkv(64, 24, 24, seed=2)
    want = jattn.attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True
    )
    got = tattn.flash_attention(*_t(q, k, v), causal=True)
    assert _max_err(got.detach(), want) <= FWD_TOL
    np.testing.assert_allclose(
        got.detach()[:, :, 0].numpy(), v.mean(axis=2), atol=FWD_TOL
    )
    assert _max_err(tattn.attention_reference(*_t(q, k, v), causal=True), want) <= FWD_TOL


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_grads_match_pallas(case):
    causal, sq, sk, kv_len, d = CASES[case]
    q, k, v = _qkv(sq, sk, kv_len, d=d, seed=3)
    w = np.random.default_rng(4).standard_normal(q.shape).astype(np.float32)

    def jloss(q, k, v):
        out = jattn._flash_pallas(q, k, v, causal, *_blocks(sq, sk), True, kv_len)
        return jnp.sum(w * out)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _t(q, k, v, grad=True)
    out = tattn.flash_attention(tq, tk, tv, causal=causal, kv_len=kv_len)
    (torch.tensor(w) * out).sum().backward()
    _assert_grads([t.grad.numpy() for t in (tq, tk, tv)], want)


@pytest.mark.parametrize("causal", [False, True])
def test_with_lse_grads_include_the_lse_cotangent(causal):
    q, k, v = _qkv(48, 48, 48, seed=5)
    rng = np.random.default_rng(6)
    w = rng.standard_normal(q.shape).astype(np.float32)
    wl = rng.standard_normal(q.shape[:3]).astype(np.float32)

    def jloss(q, k, v):
        out, lse = jattn.flash_attention_with_lse(q, k, v, causal, 16, 16, True)
        return jnp.sum(w * out) + jnp.sum(wl * lse)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _t(q, k, v, grad=True)
    out, lse = tattn.flash_attention_with_lse(tq, tk, tv, causal=causal)
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:3]
    ((torch.tensor(w) * out).sum() + (torch.tensor(wl) * lse).sum()).backward()
    _assert_grads([t.grad.numpy() for t in (tq, tk, tv)], want)


def test_lse_alone_is_differentiable():
    q, k, v = _qkv(32, 32, 32, seed=7)

    def jloss(q, k, v):
        return jnp.sum(jattn.flash_attention_with_lse(q, k, v, False, 16, 16, True)[1])

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _t(q, k, v, grad=True)
    tattn.flash_attention_with_lse(tq, tk, tv)[1].sum().backward()
    _assert_grads([t.grad.numpy() for t in (tq, tk, tv)], want)


def test_blind_rows_grads_match_reference_autodiff():
    q, k, v = _qkv(64, 24, 24, seed=8)
    w = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(w * jattn.attention_reference(q, k, v, causal=True))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _t(q, k, v, grad=True)
    (torch.tensor(w) * tattn.flash_attention(tq, tk, tv, causal=True)).sum().backward()
    _assert_grads([t.grad.numpy() for t in (tq, tk, tv)], want)


def test_kv_tail_grads_finite_at_extreme_logits():
    """Every real key anti-aligned with every query drives lse below -88;
    the recomputed exp(0 - lse) over the zero tail would be inf and
    inf * 0 a NaN without the tail selected out of P (the JAX case is
    `tests/test_ops.py::test_padded_gradients_finite_at_extreme_logits`).
    dq here is a sum of key rows that share one component of norm ~28
    whose weights sum to 0; what is left is ~0.03, so f32 rounding of the
    terms is ~1e-3 of it: dq is held to 2e-3 relative, dk and dv to the
    file's 1e-4."""
    rng = np.random.default_rng(10)
    u = rng.standard_normal(32).astype(np.float32)
    noise = lambda: 0.1 * rng.standard_normal((1, 1, 64, 32))
    q = (5.0 * u + noise()).astype(np.float32)
    k = (-5.0 * u + noise()).astype(np.float32)
    v = rng.standard_normal((1, 1, 64, 32)).astype(np.float32)
    kv_len = 45
    k[:, :, kv_len:] = 0
    v[:, :, kv_len:] = 0

    def jloss(q, k, v):
        return jnp.sum(jattn._flash_pallas(q, k, v, False, 16, 16, True, kv_len))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    _, lse = tattn.flash_reference(*_t(q, k, v), kv_len=kv_len)
    assert float(lse.max()) < -88.0
    tq, tk, tv = _t(q, k, v, grad=True)
    tattn.flash_attention(tq, tk, tv, kv_len=kv_len).sum().backward()
    got = [t.grad.numpy() for t in (tq, tk, tv)]
    assert all(np.all(np.isfinite(g)) for g in got)
    dq_ref = np.asarray(want[0])
    assert _max_err(got[0], dq_ref) <= 2e-3 * float(np.max(np.abs(dq_ref)))
    _assert_grads(got[1:], want[1:])


def _packed(b=2, s=24, h=4, d=16, seed=11):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, s, 3 * h * d)).astype(np.float32), h


def test_packed_forward_matches_pallas():
    qkv, h = _packed()
    want = jattn.flash_attention_packed(jnp.asarray(qkv), h, interpret=True)
    got = tattn.flash_attention_packed(torch.tensor(qkv), h)
    assert got.shape == want.shape
    assert _max_err(got, want) <= FWD_TOL
    assert _max_err(tattn.packed_reference(torch.tensor(qkv), h), want) <= FWD_TOL


def test_packed_grad_matches_pallas():
    qkv, h = _packed(seed=12)
    w = np.random.default_rng(13).standard_normal(qkv.shape[:2] + (qkv.shape[2] // 3,)).astype(np.float32)

    def jloss(x):
        return jnp.sum(w * jattn.flash_attention_packed(x, h, interpret=True) ** 2)

    want = jax.grad(jloss)(jnp.asarray(qkv))
    t = torch.tensor(qkv, requires_grad=True)
    (torch.tensor(w) * tattn.flash_attention_packed(t, h) ** 2).sum().backward()
    _assert_grads([t.grad.numpy()], [want])


def test_packed_unpack_is_a_view():
    qkv, h = _packed()
    t = torch.tensor(qkv)
    q, k, v = tattn.packed_unpack(t, h)
    assert q.data_ptr() == t.data_ptr()
    assert k.stride() == (t.stride(0), 16, t.stride(1), 1)
    want = jattn._packed_unpack(jnp.asarray(qkv), h)
    for a, b in zip((q, k, v), want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_cpu_tensors_launch_nothing_and_bad_packing_raises():
    tattn.reset_launch_counts()
    qkv, h = _packed()
    tattn.flash_attention_packed(torch.tensor(qkv), h)
    tattn.flash_attention(*_t(*_qkv(16, 16, 16)))
    assert all(n == 0 for n in tattn.LAUNCHES.values())
    with pytest.raises(ValueError, match="3 \\* num_heads"):
        tattn.flash_attention_packed(torch.zeros(1, 8, 100), 4)
