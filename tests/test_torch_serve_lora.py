"""The port's multi-LoRA serving (`ContinuousBatcher(adapters=...)`)
against the JAX engine's, on the CPU.

The matrix of the JAX package's `tests/test_serve_lora.py`, on its
config and workload (a 2-layer f32 model at vocab 64; prompts of 7, 137
and 3 tokens, greedy, plus one sampled request; synthetic adapters at
scale 0.02 "mild" and 0.5 "hot"), with the JAX engines built exactly as
there. Greedy tokens must equal the JAX armed engine's; sampled streams
(counter-based in the port, threefry in JAX) are held to the port's own
runs. Every port engine runs once per file (`_port`, memoized), and so
does every JAX engine (`_jax`); the JAX engines get a private copy of
every upload (`_dev`).

- adapter-0 traffic on an armed engine equals a LoRA-free engine's,
  spec on/off x loop 1/8;
- a mixed batch equals each request served alone; spec, the loop and
  prefix cache off preserve it; tokens, `lora_stats()` (but
  `load_seconds_total`), `loop_stats()` and `spec_stats()` equal JAX's;
- hot load mid-traffic equals JAX's and a cold engine; swaps are refused
  while a request uses the id; a reload drops the id's cached prefix
  blocks (a port fix: JAX's engine keeps serving them);
- unarmed, unknown-id, incompatible-set and dense-engine rejections;
- no prefix sharing across adapters;
- an MoE config under capacity drops (deltas on attention only) and an
  "int8-sim" config equal JAX's armed engines.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_serve_loop import MOE_ENGINE, MOE_FIELDS, count_decode_drops, moe_params
from walkai_nos_tpu.models import lm as jlm
from walkai_nos_tpu.models import lora as jlora
from walkai_nos_tpu.models.serve import ContinuousBatcher as JaxBatcher
from walkai_nos_tpu_torch.models import lm as tlm
from walkai_nos_tpu_torch.models import lora as tlora
from walkai_nos_tpu_torch.models.serve import ContinuousBatcher

torch.set_num_threads(1)

FIELDS = dict(vocab_size=64, hidden_dim=32, num_layers=2, num_heads=2,
              max_seq_len=512, dtype="float32")
SIM = dict(FIELDS, kv_dtype="int8-sim", w_dtype="int8-sim")
ENGINE = dict(slots=3, cache_len=384, chunk_steps=3, prefill_chunk=32)
PROMPTS = [
    list(range(1, 8)),
    [(i % 60) + 1 for i in range(137)],
    [5, 9, 2],
]
MIXED = (1, 2, 0, 3)
SCALE = {"mild": 0.02, "hot": 0.5}


def _jax_dev(self, a):
    return jnp.asarray(np.array(a, copy=True))


@pytest.fixture(scope="module")
def nets():
    """The flax params of the JAX test (PRNGKey 0) and its draft (1)."""
    jcfg = jlm.LMConfig(**FIELDS)
    params = jax.device_get(jlm.DecoderLM(jcfg).init_params(jax.random.PRNGKey(0)))
    dcfg = jlm.draft_config(jcfg)
    dparams = jax.device_get(jlm.DecoderLM(dcfg).init_params(jax.random.PRNGKey(1)))
    return {"params": params, "dparams": dparams, "fields": FIELDS}


def _set(pkg, fields, arm):
    lm, lora = (jlm, jlora) if pkg == "jax" else (tlm, tlora)
    return lora.AdapterSet.synthetic(lm.LMConfig(**fields), k=4, rank=4, seed=0,
                                     scale=SCALE[arm])


def _engine(pkg, nets, *, arm=None, spec=False, fields=FIELDS, **kw):
    lm = jlm if pkg == "jax" else tlm
    cfg = lm.LMConfig(**fields)
    if arm is not None:
        kw["adapters"] = _set(pkg, fields, arm)
    if spec:
        kw.update(spec=True, spec_k=2, draft_cfg=lm.draft_config(cfg),
                  draft_params=nets["dparams"], spec_min_accept=0.0)
    if pkg == "port":
        return ContinuousBatcher(cfg, nets["params"], device="cpu", **{**ENGINE, **kw})
    return JaxBatcher(cfg, nets["params"], **{**ENGINE, **kw})


def _workload(engine, ids):
    """tests/test_serve_lora.py's `_serve` workload: the 3 greedy prompts
    and one sampled request, under per-request adapter ids."""
    rids = [engine.submit(p, max_new_tokens=12, adapter=a)
            for p, a in zip(PROMPTS, ids)]
    rids.append(engine.submit([2, 4, 6], max_new_tokens=10, temperature=0.9,
                              seed=7, adapter=ids[3]))
    out = engine.run()
    return [out[r] for r in rids]


_RUNS: dict = {}


def _run(pkg, nets, *, arm=None, ids=(0, 0, 0, 0), spec=False, fields=FIELDS, **kw):
    """(tokens, engine) of one workload run, memoized per file."""
    key = (pkg, arm, ids, spec, tuple(sorted(fields.items())), tuple(sorted(kw.items())))
    if key not in _RUNS:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JaxBatcher, "_dev", _jax_dev)
            engine = _engine(pkg, nets, arm=arm, spec=spec, fields=fields, **kw)
            _RUNS[key] = (_workload(engine, ids), engine)
    return _RUNS[key]


def _port(nets, **kw):
    return _run("port", nets, **kw)


def _jax(nets, **kw):
    return _run("jax", nets, **kw)


GREEDY = slice(0, 3)  # the sampled stream differs by design across packages


def _lora_stats(engine):
    st = dict(engine.lora_stats())
    st.pop("load_seconds_total", None)
    st.pop("obs_disabled", None)
    return st


MODES = {"plain": {}, "loop8": dict(loop_steps=8), "spec": dict(spec=True),
         "spec_loop8": dict(spec=True, loop_steps=8)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_adapter_zero_identity(nets, mode):
    """All-adapter-0 traffic on an armed engine (nonzero deltas resident
    in ids 1..3) equals the LoRA-free engine's, sampled stream included."""
    kw = MODES[mode]
    base, _ = _port(nets, **kw)
    armed, engine = _port(nets, arm="mild", **kw)
    assert armed == base
    assert engine.lora_stats()["enabled"]
    if "loop_steps" in kw:
        assert engine.loop_stats()["dispatches"] > 0
    if kw.get("spec"):
        assert engine.spec_stats()["verify_dispatches"] > 0


def test_adapter_zero_matches_jax_armed_engine(nets):
    got, engine = _port(nets, arm="mild")
    want, jengine = _jax(nets, arm="mild")
    assert got[GREEDY] == want[GREEDY]
    assert _lora_stats(engine) == _lora_stats(jengine)


def test_adapters_diverge_and_mixed_matches_jax(nets):
    base, _ = _port(nets)
    mixed, engine = _port(nets, arm="hot", ids=MIXED)
    assert mixed[0] != base[0] and mixed[1] != base[1] and mixed[3] != base[3]
    assert mixed[2] == base[2]
    want, jengine = _jax(nets, arm="hot", ids=MIXED)
    assert mixed[GREEDY] == want[GREEDY]
    assert _lora_stats(engine) == _lora_stats(jengine)
    st = engine.lora_stats()
    assert st["enabled"] and st["capacity"] == 4 and st["rank"] == 4
    assert st["requests_total"] == {"0": 1, "1": 1, "2": 1, "3": 1}
    assert st["gather_dispatches_total"] > 0


@pytest.mark.parametrize("idx, adapter", [(0, 1), (1, 2), (3, 3)])
def test_mixed_equals_solo(nets, idx, adapter):
    """Each request of the mixed batch, served alone on a fresh armed
    engine, gives its stream from the batch (the sampled one too)."""
    mixed, _ = _port(nets, arm="hot", ids=MIXED)
    engine = _engine("port", nets, arm="hot")
    if idx == 3:
        rid = engine.submit([2, 4, 6], max_new_tokens=10, temperature=0.9, seed=7,
                            adapter=adapter)
    else:
        rid = engine.submit(PROMPTS[idx], max_new_tokens=12, adapter=adapter)
    assert engine.run()[rid] == mixed[idx]


@pytest.mark.parametrize("mode", ["loop8", "spec", "spec_loop8", "prefix_off"])
def test_modes_preserve_mixed_tokens(nets, mode):
    """The base draft proposes, each slot's adapter verifies; folds apply
    the per-slot ids. Where JAX's engine ran the same mode in its own
    test, its tokens and stats views are held here too."""
    kw = dict(MODES.get(mode, {}))
    if mode == "prefix_off":
        kw["prefix_cache"] = False
    mixed, _ = _port(nets, arm="hot", ids=MIXED)
    got, engine = _port(nets, arm="hot", ids=MIXED, **kw)
    assert got == mixed
    if mode in ("loop8", "spec"):
        want, jengine = _jax(nets, arm="hot", ids=MIXED, **kw)
        assert got[GREEDY] == want[GREEDY]
        assert _lora_stats(engine) == _lora_stats(jengine)
        view = "loop_stats" if mode == "loop8" else "spec_stats"
        port_view, jax_view = getattr(engine, view)(), getattr(jengine, view)()
        assert port_view == {k: jax_view[k] for k in port_view}
        assert port_view["dispatches" if mode == "loop8" else "verify_dispatches"] > 0


def _delta_tree(rng, *, rank=2, scale=0.5):
    """tests/test_serve_lora.py's partial adapter tree (block0's qkv)."""
    d = FIELDS["hidden_dim"]
    return {"block0": {"qkv": {
        "a": rng.standard_normal((d, rank)).astype(np.float32) / np.sqrt(d),
        "b": rng.standard_normal((rank, 3 * d)).astype(np.float32) * scale,
    }}}


def _hot_load(pkg, nets, cold=True):
    """The JAX test's hot load: adapter 1 served, reloaded between drains,
    served again beside adapter 2; then (`cold`) an engine built with the
    new tree. Returns (before, after [r1b, r2], cold [c1, c2] or None,
    the engine)."""
    engine = _engine(pkg, nets, arm="hot")
    r1 = engine.submit(PROMPTS[0], max_new_tokens=12, adapter=1)
    before = engine.run()[r1]
    engine.load_adapter(1, _delta_tree(np.random.default_rng(42)), name="swapped")
    r1b = engine.submit(PROMPTS[0], max_new_tokens=12, adapter=1)
    r2 = engine.submit(PROMPTS[2], max_new_tokens=12, adapter=2)
    out = engine.run()
    if not cold:
        return before, [out[r1b], out[r2]], None, engine
    cold_set = _set(pkg, FIELDS, "hot")
    cold_set.load(1, _delta_tree(np.random.default_rng(42)), name="swapped")
    cold = _engine(pkg, nets, adapters=cold_set)
    c1 = cold.submit(PROMPTS[0], max_new_tokens=12, adapter=1)
    c2 = cold.submit(PROMPTS[2], max_new_tokens=12, adapter=2)
    cout = cold.run()
    return before, [out[r1b], out[r2]], [cout[c1], cout[c2]], engine


def test_hot_load_mid_traffic_matches_jax(nets):
    before, after, cold, engine = _hot_load("port", nets)
    assert after[0] != before
    assert after == cold
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxBatcher, "_dev", _jax_dev)
        jbefore, jafter, _, _ = _hot_load("jax", nets, cold=False)
    assert (before, after) == (jbefore, jafter)
    st = engine.lora_stats()
    assert st["adapters"]["1"]["name"] == "swapped"
    assert st["load_seconds_total"] >= 0.0


def test_swap_refused_while_in_flight(nets):
    engine = _engine("port", nets, arm="mild", slots=2)
    engine.submit(PROMPTS[2], max_new_tokens=4, adapter=1)
    with pytest.raises(RuntimeError, match="in-flight"):
        engine.unload_adapter(1)
    with pytest.raises(RuntimeError, match="in-flight"):
        engine.load_adapter(1, _delta_tree(np.random.default_rng(7)), name="x")
    engine.run()
    engine.unload_adapter(1)
    assert "1" not in engine.lora_stats()["adapters"]
    with pytest.raises(ValueError, match="not loaded"):
        engine.submit(PROMPTS[2], max_new_tokens=4, adapter=1)
    engine.load_adapter(1, _delta_tree(np.random.default_rng(7)), name="back")
    rid = engine.submit(PROMPTS[2], max_new_tokens=4, adapter=1)
    assert len(engine.run()[rid]) == 4


def test_reload_drops_the_adapters_cached_prefix(nets):
    """A 300-token prompt parks 2 blocks under adapter 1; reloading id 1
    drops them, so the next request under it prefills anew and equals a
    cold engine built with the new weights; adapter 2's blocks stay."""
    p = [(i % 60) + 1 for i in range(300)]
    tree = _delta_tree(np.random.default_rng(11))
    engine = _engine("port", nets, arm="hot", slots=2)
    for adapter in (1, 2):
        rid = engine.submit(p, max_new_tokens=8, adapter=adapter)
        engine.run()
    assert engine.prefix_stats()["cached_blocks"] == 4
    engine.load_adapter(1, tree, name="new")
    assert engine.prefix_stats()["cached_blocks"] == 2
    rid = engine.submit(p, max_new_tokens=8, adapter=1)
    got = engine.run()[rid]
    assert engine.prefix_stats()["block_hits"] == 0
    cold_set = _set("port", FIELDS, "hot")
    cold_set.load(1, tree, name="new")
    cold = _engine("port", nets, adapters=cold_set, slots=2)
    rid = cold.submit(p, max_new_tokens=8, adapter=1)
    assert got == cold.run()[rid]
    rid = engine.submit(p, max_new_tokens=8, adapter=2)
    engine.run()
    assert engine.prefix_stats()["block_hits"] == 2
    engine.unload_adapter(2)
    assert engine.prefix_stats()["cached_blocks"] == 2
    assert len(engine.pool.free_blocks) + engine.pool.parked_count() == (
        engine.pool_blocks - 1)


def test_no_cross_adapter_prefix_sharing(nets):
    engine = _engine("port", nets, arm="hot", slots=2)
    p = [(i % 60) + 1 for i in range(300)]
    r0 = engine.submit(p, max_new_tokens=8, adapter=0)
    base = engine.run()[r0]
    assert engine.prefix_stats()["block_hits"] == 0
    r1 = engine.submit(p, max_new_tokens=8, adapter=1)
    first = engine.run()[r1]
    assert engine.prefix_stats()["block_hits"] == 0
    assert first != base
    r1b = engine.submit(p, max_new_tokens=8, adapter=1)
    again = engine.run()[r1b]
    assert engine.prefix_stats()["block_hits"] == 2
    assert again == first
    assert engine.drain_done_records() == {}


def test_records_carry_the_adapter(nets):
    engine = _engine("port", nets, arm="mild")
    rids = [engine.submit(PROMPTS[2], max_new_tokens=3, adapter=a) for a in (0, 2, None)]
    records = {}
    while engine.has_work:
        engine.step()
        records.update(engine.drain_done_records())
    assert [records[r]["adapter"] for r in rids] == [0, 2, 0]


def test_unarmed_engine_rejects_adapter_requests(nets):
    engine = _engine("port", nets, slots=1, cache_len=128)
    with pytest.raises(ValueError, match="no adapter set"):
        engine.submit(PROMPTS[2], max_new_tokens=4, adapter=1)
    assert engine.obs.errors.value(labels={"reason": "bad_request"}) == 1
    assert not engine.has_work
    assert engine.lora_stats() == {"enabled": False}
    for swap in (lambda: engine.unload_adapter(1),
                 lambda: engine.load_adapter(1, {}, name="x")):
        with pytest.raises(RuntimeError, match="not adapter-armed"):
            swap()


def test_unknown_adapter_rejected(nets):
    engine = _engine("port", nets, arm="mild", slots=1, cache_len=128)
    with pytest.raises(ValueError, match="not loaded"):
        engine.submit(PROMPTS[2], max_new_tokens=4, adapter=9)
    assert engine.obs.errors.value(labels={"reason": "bad_request"}) == 1
    assert engine.lora_stats()["requests_total"] == {"0": 0, "1": 0, "2": 0, "3": 0}


def test_incompatible_set_rejected_at_build(nets):
    other = tlm.LMConfig(**dict(FIELDS, hidden_dim=16))
    with pytest.raises(ValueError, match="do not match"):
        _engine("port", nets, adapters=tlora.AdapterSet.synthetic(other, k=2),
                slots=1, cache_len=128)


def test_dense_engine_rejected(nets):
    with pytest.raises(ValueError, match="paged"):
        _engine("port", nets, arm="mild", slots=1, cache_len=128, paged=False)


def _moe_serve(pkg, params, aset, ids):
    lm = jlm if pkg == "jax" else tlm
    cfg = lm.LMConfig(**MOE_FIELDS)
    kw = dict(MOE_ENGINE) if aset is None else dict(MOE_ENGINE, adapters=aset)
    if pkg == "port":
        engine = ContinuousBatcher(cfg, params, device="cpu", **kw)
        drops = count_decode_drops(engine.model)
    else:
        engine, drops = JaxBatcher(cfg, params, **kw), None
    rng = np.random.default_rng(5)
    waves = [[(rng.integers(0, 64, int(rng.integers(3, 40))).astype(np.int32), m, a)
              for m, a in zip(budgets, wave_ids)]
             for budgets, wave_ids in (((9, 5, 12), ids[:3]), ((7,), ids[3:4]),
                                       ((4, 10), ids[4:]))]
    rids = []
    for i, wave in enumerate(waves):
        if i:
            engine.step()
        rids += [engine.submit(p, max_new_tokens=m, adapter=a) for p, m, a in wave]
    out = engine.run()
    return [out[r] for r in rids], drops


def test_moe_under_drops_matches_jax():
    """GQA + MoE at capacity 1.25 (drops; idle slots beside live ones):
    deltas on every attention and on the dense block's MLP, none on the
    MoE block's (its gate/fc1/fc2 stacks are dead: rewriting them changes
    no token)."""
    params = moe_params()
    ids = (1, 0, 2, 3, 2, 1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxBatcher, "_dev", _jax_dev)
        jset = jlora.AdapterSet.synthetic(jlm.LMConfig(**MOE_FIELDS), k=4, rank=4,
                                          scale=0.5)
        want, _ = _moe_serve("jax", params, jset, ids)
    tcfg = tlm.LMConfig(**MOE_FIELDS)
    got, drops = _moe_serve("port", params,
                            tlora.AdapterSet.synthetic(tcfg, k=4, rank=4, scale=0.5), ids)
    assert got == want
    assert drops[0] > 0
    base, _ = _moe_serve("port", params, None, (0,) * len(ids))
    assert base != got
    dead = tlora.AdapterSet.synthetic(tcfg, k=4, rank=4, scale=0.5)
    for proj in ("gate", "fc1", "fc2"):
        dead.host_tree()["block1"][proj]["lora_b"][1:] = 7.0
    assert _moe_serve("port", params, dead, ids)[0] == got


def test_int8_sim_matches_jax(nets):
    """"int8-sim" KV and weights (QuantDense outputs, quantizing scatter
    with unit scales) under a mixed batch: JAX's tokens, and the
    unquantized port engine's."""
    got, _ = _port(nets, arm="hot", ids=MIXED, fields=SIM)
    want, _ = _jax(nets, arm="hot", ids=MIXED, fields=SIM)
    assert got[GREEDY] == want[GREEDY]
    assert got == _port(nets, arm="hot", ids=MIXED)[0]
