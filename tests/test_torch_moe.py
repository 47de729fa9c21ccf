"""The port's MoE layer (`models/moe.py`) against the JAX package's, on
the same weights (flax params bridged by `models/convert.py`) and inputs.

f32 on both sides, so outputs agree up to summation order: within 1e-5
of the largest |output| + 1e-6, and the aux loss within 1e-6 relative.
The routing cases follow tests/test_moe.py: one expert equals the dense
up/gelu/down; overflow tokens past capacity get no MoE output (a
position at or past capacity has no slot: the one-hot trap); top-2
weights are renormalized; the aux loss is taken before capacity. Three
MoE training steps (aux term included) agree with the JAX step as the
dense ones do in tests/test_torch_lm_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkai_nos_tpu.models.moe import MoEMlp as JaxMoE
from walkai_nos_tpu_torch.models.convert import load_flax_params
from walkai_nos_tpu_torch.models.moe import MoEMlp, aux_loss_from_intermediates

from tests.test_torch_lm_train import FAMILIES, _tokens, assert_params_match, run_three_steps

torch.set_num_threads(1)


def _x(b=2, s=8, d=16, seed=0):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def _both(x, *, num_experts, top_k, capacity_factor, mlp_dim=32, seed=0, same_experts=False):
    """(JAX output, JAX aux, port output, port aux, params) for one MoE
    layer on x, f32."""
    d = x.shape[-1]
    kw = dict(hidden_dim=d, mlp_dim=mlp_dim, num_experts=num_experts, top_k=top_k,
              capacity_factor=capacity_factor, dtype=jnp.float32)
    jmoe = JaxMoE(**kw)
    params = jax.device_get(jmoe.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"])
    params = jax.tree.map(np.array, params)  # writable copies
    rng = np.random.default_rng(seed)
    params["router"]["bias"] = rng.normal(0, 0.1, num_experts).astype(np.float32)
    if same_experts:
        params["experts_up"][:] = params["experts_up"][:1]
        params["experts_down"][:] = params["experts_down"][:1]
    jy, state = jmoe.apply({"params": params}, jnp.asarray(x), mutable=["intermediates"])
    jaux = jax.tree_util.tree_leaves(state["intermediates"])[0]
    tmoe = MoEMlp(d, mlp_dim, num_experts, top_k=top_k, capacity_factor=capacity_factor,
                  dtype=torch.float32, param_dtype=torch.float32, device="cpu",
                  gen=torch.Generator().manual_seed(seed))
    load_flax_params(tmoe, params)
    with torch.no_grad():
        ty, taux = tmoe(torch.from_numpy(x))
    return np.asarray(jy), float(jaux), ty.numpy(), float(taux), params, tmoe


def _close(got, want):
    err = np.max(np.abs(got - want))
    assert err <= 1e-5 * np.max(np.abs(want)) + 1e-6, err


def test_single_expert_equals_dense_mlp():
    x = _x()
    jy, jaux, ty, taux, params, _ = _both(x, num_experts=1, top_k=1, capacity_factor=1.0)
    xt = torch.from_numpy(x).reshape(-1, 16)
    dense = torch.nn.functional.gelu(
        xt @ torch.from_numpy(params["experts_up"][0]), approximate="tanh"
    ) @ torch.from_numpy(params["experts_down"][0])
    _close(ty, dense.numpy().reshape(x.shape))
    _close(ty, jy)
    assert taux == pytest.approx(jaux, rel=1e-6) and taux == pytest.approx(1.0, rel=1e-6)


def test_capacity_overflow_tokens_fall_through():
    """Capacity 1 per expert: at most 2 of 16 tokens are routed, the rest
    sit at positions 1.. of their expert, past capacity, and get zeros."""
    x = _x(b=1, s=16)
    jy, jaux, ty, taux, _, tmoe = _both(x, num_experts=2, top_k=1, capacity_factor=1 / 8)
    assert tmoe.capacity(16) == 1
    zero_rows = int(np.sum(np.all(ty.reshape(-1, 16) == 0.0, axis=-1)))
    assert zero_rows >= 14
    _close(ty, jy)
    assert taux == pytest.approx(jaux, rel=1e-6)


def test_top2_weights_renormalized():
    """Identical experts: the combine step yields (sum of kept weights) x
    the dense MLP, which equals it only if the kept weights sum to 1."""
    x = _x(seed=1)
    jy, _, ty, _, params, _ = _both(x, num_experts=4, top_k=2, capacity_factor=4.0,
                                    same_experts=True)
    xt = torch.from_numpy(x).reshape(-1, 16)
    dense = torch.nn.functional.gelu(
        xt @ torch.from_numpy(params["experts_up"][0]), approximate="tanh"
    ) @ torch.from_numpy(params["experts_down"][0])
    _close(ty, dense.numpy().reshape(x.shape))
    _close(ty, jy)


@pytest.mark.parametrize("capacity_factor", [0.25, 1.25])
def test_aux_loss_is_taken_before_capacity(capacity_factor):
    """E * sum(frac_top1 * mean_prob) from the router alone, whatever the
    capacity drops; both capacities give the JAX layer's outputs."""
    x = _x(b=2, s=16, seed=2)
    jy, jaux, ty, taux, params, tmoe = _both(
        x, num_experts=4, top_k=2, capacity_factor=capacity_factor
    )
    logits = x.reshape(-1, 16) @ params["router"]["kernel"] + params["router"]["bias"]
    probs = torch.softmax(torch.from_numpy(logits), -1)
    frac = torch.nn.functional.one_hot(probs.argmax(-1), 4).float().mean(0)
    want = float(4 * (frac * probs.mean(0)).sum())
    assert taux == pytest.approx(want, rel=1e-6)
    assert taux == pytest.approx(jaux, rel=1e-6)
    _close(ty, jy)
    if capacity_factor < 1:
        assert tmoe.capacity(32) == 4  # 32 tokens x 2 choices over 16 slots
        assert np.sum(np.all(ty.reshape(-1, 16) == 0.0, axis=-1)) > 0


def test_aux_loss_from_intermediates_sums_the_layers():
    assert float(aux_loss_from_intermediates([])) == 0.0
    sown = [torch.tensor(0.5), torch.tensor(1.25)]
    assert float(aux_loss_from_intermediates(sown)) == 1.75


def test_three_moe_train_steps_match_jax():
    """An LM with an MoE MLP on every second block (4 experts, top-2):
    losses (LM loss + 1e-2 x aux) and parameters after three AdamW steps
    against the JAX step on a one-device mesh."""
    fields = dict(FAMILIES["gpt2"], num_experts=4, moe_every=2)
    jlosses, tlosses, jparams, tstate = run_three_steps(fields, _tokens())
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert tlosses[-1] < tlosses[0]
    model = tstate.params
    assert model.blocks[0].moe is None and model.blocks[1].moe is not None
    assert_params_match(model, jparams, fields["hidden_dim"])
    # The no-cache forward reports one aux loss per MoE layer.
    sown = []
    with torch.no_grad():
        model(torch.from_numpy(_tokens()), intermediates=sown)
    assert len(sown) == 1 and sown[0].dim() == 0

