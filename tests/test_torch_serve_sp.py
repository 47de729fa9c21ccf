"""The port's sequence-parallel prefill lane (`ContinuousBatcher(
sp_prefill=True)`) against its serial lane and against the JAX engine's,
on the CPU.

The workload of the JAX package's `tests/test_serve_sp.py` (2-layer
model at vocab 64, in f32 here; a 96-token long threshold, 32-token
chunks, 4 lane rows, span 3): two longs (140 crosses the 128-row block
edge mid-prefill, 300 spans three blocks), one just over the threshold
(97) and a short beside them. The fan-out changes scheduling, never
tokens: sp on equals sp off, greedy and sampled, prefix cache on and
off, and the greedy tokens and `sp_stats()` equal the JAX engine's sp-on
run of the same traffic. Admission is length-aware: one long prefills
at a time, and a held long is jumped by the short behind it. An MoE
model under capacity drops routes JAX's lane rows. The JAX engines get
a private copy of every upload (`_dev`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_serve_loop import MOE_FIELDS, moe_params
from walkai_nos_tpu.models import lm as jlm
from walkai_nos_tpu.models.serve import ContinuousBatcher as JaxBatcher
from walkai_nos_tpu_torch.models import lm as tlm
from walkai_nos_tpu_torch.models.serve import ContinuousBatcher

torch.set_num_threads(1)

FIELDS = dict(vocab_size=64, hidden_dim=32, num_layers=2, num_heads=2,
              max_seq_len=512, dtype="float32")
ENGINE = dict(slots=3, cache_len=384, chunk_steps=3, prefill_chunk=32,
              prefill_lanes=4, sp_min_tokens=96, sp_span=3)
SPECS = [(140, 9), (20, 12), (300, 8), (97, 11)]
# A second wave on the same engines: the second long is held while the
# first prefills, and the short behind it admits.
HELD = [(140, 6), (150, 6), (20, 6)]


def _prompt(n, seed=None, vocab=64):
    rng = np.random.default_rng(n if seed is None else seed)
    return rng.integers(0, vocab, n).astype(np.int32)


def _jax_dev(self, a):
    return jnp.asarray(np.array(a, copy=True))


def _submit(eng, specs, **kw):
    return {eng.submit(_prompt(n), max_new_tokens=m, **kw): (n, m)
            for n, m in specs}


def _waves(eng):
    """SPECS run to the end, then HELD stepped once and run to the end;
    what both engines must agree on."""
    rids = _submit(eng, SPECS)
    out = eng.run()
    first = {rids[r]: t for r, t in out.items()}
    stats = [eng.sp_stats()]
    rids = _submit(eng, HELD)
    eng.step()
    stats.append(eng.sp_stats())
    held = [len(r.prompt) for r in eng._pending]
    out = eng.run()
    second = {rids[r]: t for r, t in out.items()}
    stats.append(eng.sp_stats())
    return {"first": first, "second": second, "stats": stats, "held": held}


@pytest.fixture(scope="module")
def params():
    cfg = jlm.LMConfig(**FIELDS)
    return jax.device_get(jlm.DecoderLM(cfg).init_params(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def jax_waves(params):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxBatcher, "_dev", _jax_dev)
        eng = JaxBatcher(jlm.LMConfig(**FIELDS), params, sp_prefill=True,
                         **ENGINE)
        return _waves(eng)


def _port(params, sp=True, **kw):
    return ContinuousBatcher(tlm.LMConfig(**FIELDS), params, device="cpu",
                             **{**ENGINE, "sp_prefill": sp, **kw})


def _run(eng, specs, **kw):
    rids = _submit(eng, specs, **kw)
    out = eng.run()
    return {rids[r]: t for r, t in out.items()}


@pytest.mark.parametrize("prefix", [True, False], ids=["prefix-on", "prefix-off"])
def test_greedy_sp_on_equals_sp_off(params, prefix):
    on = _port(params, True, prefix_cache=prefix)
    got = _run(on, SPECS)
    st = on.sp_stats()
    assert st["requests_total"] == 3  # 140, 300, 97
    assert st["rows_total"] > st["requests_total"]  # the fan-out ran
    assert st["active"] == 0
    assert got == _run(_port(params, False, prefix_cache=prefix), SPECS)


@pytest.mark.parametrize("prefix", [True, False], ids=["prefix-on", "prefix-off"])
def test_sampled_sp_on_equals_sp_off(params, prefix):
    """The span's finishing row seeds the slot's draws as the serial
    lane's final chunk does."""
    knobs = dict(temperature=0.9, top_k=16, top_p=0.95, seed=123)
    outs = [_run(_port(params, sp, prefix_cache=prefix), SPECS[:2], **knobs)
            for sp in (True, False)]
    assert outs[0] == outs[1]


def test_greedy_tokens_and_sp_stats_match_jax(params, jax_waves):
    got = _waves(_port(params))
    assert got["first"] == jax_waves["first"]
    assert got["second"] == jax_waves["second"]
    assert got["stats"] == jax_waves["stats"]
    assert got["held"] == jax_waves["held"] == [150]


def test_second_long_held_and_short_jumps(params):
    """One long entry at a time: the second long waits (holds_total
    counts the turn) while the short behind it admits; a long never
    jumps anything."""
    eng = _port(params)
    rids = _submit(eng, HELD)
    eng.step()
    st = eng.sp_stats()
    assert st["active"] == 1 and st["requests_total"] == 1
    assert st["holds_total"] >= 1
    assert [len(r.prompt) for r in eng._pending] == [150]
    out = {rids[r]: t for r, t in eng.run().items()}
    assert eng.sp_stats()["requests_total"] == 2
    assert out == _run(_port(params, False), HELD)


def test_block_boundary_prompts(params):
    """Lengths straddling the 128-row block edge and an exact two-block
    prompt land every fanned window in the right block."""
    specs = [(127, 6), (128, 6), (129, 6), (256, 5)]
    on = _port(params, slots=2)
    assert _run(on, specs) == _run(_port(params, False, slots=2), specs)
    assert on.sp_stats()["requests_total"] == 4


def test_shorts_admitted_beside_a_live_sp_entry(params):
    eng = _port(params)
    long_rid = eng.submit(_prompt(300), max_new_tokens=8)
    eng.step()
    assert eng.sp_stats()["active"] == 1
    shorts = {eng.submit(_prompt(n), max_new_tokens=7): n for n in (30, 45)}
    concurrent, out = False, {}
    while eng.has_work:
        eng.step()
        concurrent |= eng.sp_stats()["active"] == 1 and len(eng._prefilling) >= 2
        out.update(eng.drain_done())
    assert concurrent
    want = _run(_port(params, False), [(300, 8), (30, 7), (45, 7)])
    assert out[long_rid] == want[(300, 8)]
    for rid, n in shorts.items():
        assert out[rid] == want[(n, 7)]


def test_short_only_traffic_never_touches_sp(params):
    specs = [(20, 8), (40, 8), (64, 8)]
    eng = _port(params)
    got = _run(eng, specs)
    st = eng.sp_stats()
    assert (st["requests_total"], st["rows_total"], st["holds_total"]) == (0, 0, 0)
    assert got == _run(_port(params, False), specs)


@pytest.mark.parametrize(
    "kwargs",
    [dict(sp_min_tokens=0), dict(sp_span=-1),
     dict(paged=False, sp_prefill=True)],
    ids=["sp_min_tokens", "sp_span", "dense"],
)
def test_knob_errors_are_jax_errors(params, kwargs):
    base = dict(slots=2, cache_len=256, prefill_chunk=32)
    with pytest.raises(ValueError) as want:
        JaxBatcher(jlm.LMConfig(**FIELDS), params, **base, **kwargs)
    with pytest.raises(ValueError) as got:
        ContinuousBatcher(tlm.LMConfig(**FIELDS), params, device="cpu",
                          **base, **kwargs)
    assert str(got.value) == str(want.value)


def test_span_auto_sizes_and_stats_keys(params, jax_waves):
    eng = _port(params, sp_span=0)
    assert eng.sp_span == 2
    st = eng.sp_stats()
    assert st["enabled"] is True and st["sp_span"] == 2
    assert st["sp_min_tokens"] == 96
    assert set(st) == set(jax_waves["stats"][0])
    # The dense engine takes the knobs and keeps the lane off.
    dense = ContinuousBatcher(tlm.LMConfig(**FIELDS), params, device="cpu",
                              slots=2, cache_len=256, paged=False,
                              sp_min_tokens=96)
    assert dense.sp_stats()["enabled"] is False


MOE_SP = dict(slots=3, cache_len=256, chunk_steps=2, prefill_chunk=16,
              prefill_lanes=4, sp_min_tokens=48, sp_span=3)
MOE_SPECS = [(100, 5), (12, 5), (70, 5)]


def _lane_drops(model):
    """Hooks counting the assignments capacity drops in the routed rows
    of wide (lane) MoE calls; returns a one-element list."""
    drops = [0]

    def hook(moe, args):
        h, rows = args[0], args[1] if len(args) > 1 else None
        if h.shape[1] == 1:
            return
        routed = h[: (h.shape[0] if rows is None else rows)]
        flat = routed.reshape(-1, h.shape[-1])
        gates = torch.softmax(moe.router(flat), -1)
        chosen = torch.topk(gates, moe.top_k, dim=-1).indices
        load = torch.bincount(chosen.reshape(-1), minlength=moe.num_experts)
        drops[0] += int(torch.clamp(load - moe.capacity(flat.shape[0]), min=0).sum())

    for m in model.modules():
        if m.__class__.__name__ == "MoEMlp":
            m.register_forward_pre_hook(hook)
    return drops


def test_moe_under_drops_routes_jax_lane_rows():
    """Capacity 1.25 drops tokens in the fanned lane; the port routes the
    rows JAX's lane routes (a power of two of the rows in use), so the
    greedy tokens equal the JAX sp-on engine's."""
    params = moe_params()
    prompts = [(_prompt(n, vocab=64), m) for n, m in MOE_SPECS]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxBatcher, "_dev", _jax_dev)
        jeng = JaxBatcher(jlm.LMConfig(**MOE_FIELDS), params,
                          sp_prefill=True, **MOE_SP)
        jr = [jeng.submit(p, max_new_tokens=m) for p, m in prompts]
        jout = jeng.run()
    eng = ContinuousBatcher(tlm.LMConfig(**MOE_FIELDS), params, device="cpu",
                            sp_prefill=True, **MOE_SP)
    drops = _lane_drops(eng.model)
    tr = [eng.submit(p, max_new_tokens=m) for p, m in prompts]
    tout = eng.run()
    assert drops[0] > 0
    assert eng.sp_stats()["rows_total"] > eng.sp_stats()["requests_total"]
    assert [tout[r] for r in tr] == [jout[r] for r in jr]
    assert eng.sp_stats() == jeng.sp_stats()
