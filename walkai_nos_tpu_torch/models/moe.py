"""Mixture-of-Experts MLP, on one device.

Port of `walkai_nos_tpu/models/moe.py`. Routing is dense one-hot
dispatch/combine einsums over [tokens, experts, capacity] with a static
per-expert capacity, so every step has one set of shapes; tokens past an
expert's capacity are dropped and fall through the block's residual
connection. The JAX module pins the expert dimension to the mesh's
`expert` axis with sharding constraints; on one device they are no-ops
and have no counterpart here (expert parallelism is a later slice).

The JAX module `sow`s its load-balancing loss into the `intermediates`
collection; here `MoEMlp.forward` returns it beside the output, the LM's
no-cache forward appends each MoE layer's to the list its caller passes
(`DecoderLM.forward(tokens, intermediates=...)`), and
`aux_loss_from_intermediates` sums them. The cache forwards drop it, as
nothing reads what JAX's decode forward sows.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["MoEMlp", "aux_loss_from_intermediates"]


def _normal(shape, std, store, device, gen, train) -> nn.Parameter:
    t = torch.randn(shape, generator=gen, device=device) * std
    return nn.Parameter(t.to(store), requires_grad=train)


class _Router(nn.Module):
    """flax `nn.Dense(num_experts, dtype=f32)`: f32 kernel [d, E] and
    bias, computed in f32 (gate ordering must not wobble with bf16
    rounding)."""

    def __init__(self, d, num_experts, *, device, gen, train):
        super().__init__()
        self.kernel = _normal((d, num_experts), 0.02, torch.float32, device, gen, train)
        self.bias = nn.Parameter(
            torch.zeros(num_experts, device=device), requires_grad=train
        )

    def forward(self, x):
        return x.float() @ self.kernel + self.bias


class MoEMlp(nn.Module):
    """Drop-in replacement for the dense fc1/gelu/fc2 MLP: top-k routing
    with static per-expert capacity, gelu (tanh) experts stacked as
    `experts_up` [E, d, f] and `experts_down` [E, f, d], computed in
    `dtype`.

    Storage follows the LM's builds: `param_dtype=None` (serving) keeps
    the experts in `dtype` and nothing trains; `param_dtype=torch.float32`
    holds f32 masters that train, cast to `dtype` at every call. The
    router is f32 in both. Random weights are normal with std 0.02 from
    `gen` until `models/convert.py` loads a JAX tree."""

    def __init__(
        self,
        hidden_dim: int,
        mlp_dim: int,
        num_experts: int,
        *,
        top_k: int = 2,
        capacity_factor: float = 1.25,
        dtype: torch.dtype = torch.bfloat16,
        param_dtype: torch.dtype | None = None,
        device,
        gen,
    ):
        super().__init__()
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor, self.dtype = capacity_factor, dtype
        train = param_dtype is not None
        store = param_dtype or dtype
        kw = dict(device=device, gen=gen, train=train)
        self.router = _Router(hidden_dim, num_experts, **kw)
        self.experts_up = _normal((num_experts, hidden_dim, mlp_dim), 0.02, store, **kw)
        self.experts_down = _normal((num_experts, mlp_dim, hidden_dim), 0.02, store, **kw)

    def capacity(self, tokens: int) -> int:
        """Slots per expert: ceil(capacity_factor * tokens * k / E), at
        least 1 and at most `tokens`."""
        c = math.ceil(self.capacity_factor * tokens * self.top_k / self.num_experts)
        return min(max(1, c), tokens)

    def forward(
        self, x: torch.Tensor, rows: int | None = None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """x [batch, seq, d] -> (y [batch, seq, d] in x's dtype, the
        GShard load-balancing loss, f32 0-d).

        `rows` routes only the first `rows` batch rows, as JAX's call
        over exactly those rows would: their capacity comes from their
        rows x seq tokens, and the other rows get a zero output and take
        no slot. The expert buffers keep the width of the whole batch,
        so the products have one shape whatever `rows` is (the paged
        engine's prefill lane: JAX sizes its lane to the rows in use,
        the port's runs all of them)."""
        batch, seq, d = x.shape
        num_experts = self.num_experts
        tokens = batch * seq
        routed = tokens if rows is None else rows * seq
        xt = x.reshape(tokens, d)
        gates = torch.softmax(self.router(xt), dim=-1)  # [T, E] f32
        capacity = self.capacity(routed)
        width = self.capacity(tokens)
        slots = torch.arange(width, device=x.device, dtype=torch.float32)
        live = (torch.arange(tokens, device=x.device) < routed).float()[:, None]

        combine = torch.zeros(tokens, num_experts, width, device=x.device)
        occupancy = torch.zeros(1, num_experts, device=x.device)
        remaining = gates
        weights, first = [], None
        for _ in range(self.top_k):
            # Repeated argmax with the earlier rounds' choices masked out.
            mask = F.one_hot(remaining.argmax(-1), num_experts).float() * live
            first = mask if first is None else first
            remaining = remaining * (1.0 - mask)
            # Each token's slot in its chosen expert's buffer, after what
            # earlier rounds filled; past capacity the token is dropped.
            position = torch.cumsum(mask, 0) - mask + occupancy
            mask = mask * (position < capacity)
            occupancy = occupancy + mask.sum(0, keepdim=True)
            kept = (gates * mask).sum(-1)  # [T]
            weights.append(kept)
            # The slot's one-hot by comparison: a position at or past
            # capacity has none (JAX's one_hot gives zeros there, where
            # F.one_hot would raise).
            slot = (position[..., None] == slots).float()
            combine = combine + mask[..., None] * slot * kept[:, None, None]
        # Renormalize so the kept experts' weights sum to 1.
        combine = combine / torch.clamp(sum(weights), min=1e-9)[:, None, None]
        dispatch = (combine > 0.0).to(self.dtype)  # [T, E, C]

        # GShard's load-balancing loss on the assignment BEFORE capacity:
        # truncating would cap the penalty exactly when an expert
        # overflows.
        aux = num_experts * (first[:routed].mean(0) * gates[:routed].mean(0)).sum()

        w_up = self.experts_up.to(self.dtype)
        w_down = self.experts_down.to(self.dtype)
        expert_in = torch.einsum("tec,td->ecd", dispatch, xt.to(self.dtype))
        h = F.gelu(torch.einsum("ecd,edf->ecf", expert_in, w_up), approximate="tanh")
        out = torch.einsum("ecf,efd->ecd", h, w_down)
        y = torch.einsum("tec,ecd->td", combine.to(self.dtype), out)
        return y.reshape(batch, seq, d).to(x.dtype), aux


def aux_loss_from_intermediates(intermediates) -> torch.Tensor:
    """Sum every MoE layer's aux loss (the list the LM's no-cache forward
    filled); 0.0 when it holds none."""
    total = torch.zeros(())
    for leaf in intermediates:
        total = total + leaf.float().sum()
    return total
