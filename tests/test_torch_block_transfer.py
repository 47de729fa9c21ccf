"""KV block transfer and live migration between the port's engines and
the JAX engine's (`models/serve_xfer.py`), on the CPU.

The JAX package's `tests/test_block_transfer.py` workload (a 2-layer
model at vocab 64, f32 here; 2 slots, 32-token chunks): payloads go
both ways between the packages.

- `export_blocks` -> `import_blocks`: the importer serves the exporter's
  prompt with a 2-block prefix hit and the exporter's greedy tokens.
- `export_resident` -> `import_resident` mid-stream: the stream finishes
  with the tokens of the JAX engine's uninterrupted run, for f32 KV,
  int8 KV (data and scale tiles) and a speculative engine (draft tiles);
  bf16 tiles round-trip byte for byte through both packages.
- Port to port, a sampled stream continues exactly.
- Rejections carry JAX's reasons; queued and prefilling requests travel
  as resubmits; `only=` leaves the other streams serving; the drain
  surface reads as JAX's on the same traffic.

One JAX engine per KV kind serves as the uninterrupted reference, as an
exporter and as an importer. The JAX engines get a private copy of every
upload (`_dev`).
"""

import base64
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkai_nos_tpu.models import lm as jlm
from walkai_nos_tpu.models.serve import ContinuousBatcher as JaxBatcher
from walkai_nos_tpu_torch.models import lm as tlm
from walkai_nos_tpu_torch.models.block_key import chain_hashes
from walkai_nos_tpu_torch.models.serve import ContinuousBatcher
from walkai_nos_tpu_torch.models.serve_xfer import kv_leaves

torch.set_num_threads(1)

FIELDS = dict(vocab_size=64, hidden_dim=32, num_layers=2, num_heads=2,
              max_seq_len=512, dtype="float32")
KINDS = {
    "f32": dict(FIELDS),
    "int8": dict(FIELDS, kv_dtype="int8"),
    "spec": dict(FIELDS),
}
ENGINE = dict(slots=2, cache_len=384, chunk_steps=3, prefill_chunk=32,
              prefill_lanes=2)
MIGRANT = (140, 40)  # prompt length (seed 7), new tokens
DRAIN = [(140, 10), (30, 12), (60, 9)]


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(0, 64, n).astype(np.int32)


def _jax_dev(self, a):
    return jnp.asarray(np.array(a, copy=True))


@pytest.fixture(scope="module")
def nets():
    cfg = jlm.LMConfig(**FIELDS)
    params = jax.device_get(jlm.DecoderLM(cfg).init_params(jax.random.PRNGKey(0)))
    dcfg = jlm.draft_config(cfg)
    dparams = jax.device_get(jlm.DecoderLM(dcfg).init_params(jax.random.PRNGKey(1)))
    return {"params": params, "dparams": dparams}


@pytest.fixture(autouse=True)
def _jax_copies(monkeypatch):
    monkeypatch.setattr(JaxBatcher, "_dev", _jax_dev)


def _spec_kw(pkg, nets, kind):
    if kind != "spec":
        return {}
    lm = jlm if pkg == "jax" else tlm
    return dict(spec=True, spec_k=3, draft_params=nets["dparams"],
                draft_cfg=lm.draft_config(lm.LMConfig(**FIELDS)))


def _jax(nets, kind="f32", **kw):
    return JaxBatcher(jlm.LMConfig(**KINDS[kind]), nets["params"],
                      **_spec_kw("jax", nets, kind), **{**ENGINE, **kw})


def _port(nets, kind="f32", **kw):
    return ContinuousBatcher(tlm.LMConfig(**KINDS[kind]), nets["params"],
                             device="cpu", **_spec_kw("port", nets, kind),
                             **{**ENGINE, **kw})


def _serve(eng, prompt, new, **kw):
    rid = eng.submit(prompt, max_new_tokens=new, **kw)
    return eng.run()[rid]


def _mid_stream(eng, prompt, new, steps=3, **kw):
    """Submit, step until the first token commits and `steps` turns
    more; returns the rid."""
    rid = eng.submit(prompt, max_new_tokens=new, **kw)
    while not eng._requests[rid].tokens:
        eng.step()
    for _ in range(steps):
        eng.step()
    return rid


def _surface(eng):
    return {
        "queue_depth": eng.queue_depth,
        "draining": eng.draining,
        "drain_stats": eng.drain_stats(),
        "decode_ready": eng.decode_ready_rids(),
        "new_tokens": eng.drain_new_tokens(),
    }


def _drain_trace(eng):
    """The drain surface after every turn of DRAIN's traffic, then the
    records' rids, the latencies' count and the drained engine."""
    assert eng.seconds_since_last_dispatch is None
    for n, m in DRAIN:
        eng.submit(_prompt(n, n), max_new_tokens=m)
    trace = [_surface(eng)]
    done = {}
    while eng.has_work:
        eng.step()
        trace.append(_surface(eng))
        done.update(eng.drain_done_records())
    assert eng.seconds_since_last_dispatch >= 0.0
    assert eng.admission_stall_s > 0.0
    eng.drain()
    trace.append(_surface(eng))
    return trace, sorted(done), len(eng.drain_latencies()), len(eng.drain_latencies())


@pytest.fixture(scope="module")
def jax_runs(nets):
    """Per KV kind, its JAX engine, built at first use: the drain trace
    (f32 only), then the uninterrupted migrant."""
    runs = {}

    def run(kind):
        if kind not in runs:
            eng = _jax(nets, kind)
            trace = _drain_trace(eng) if kind == "f32" else None
            eng._draining = False
            ref = _serve(eng, _prompt(MIGRANT[0], 7), MIGRANT[1])
            runs[kind] = {"engine": eng, "trace": trace, "ref": ref}
        return runs[kind]

    return run


def test_drain_surface_matches_jax(nets, jax_runs):
    want = jax_runs("f32")["trace"]
    assert _drain_trace(_port(nets)) == want


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_midstream_jax_to_port(nets, jax_runs, kind):
    ref = jax_runs(kind)
    jeng = ref["engine"]
    _mid_stream(jeng, _prompt(MIGRANT[0], 7), MIGRANT[1])
    payload = json.loads(json.dumps(jeng.export_resident()))
    assert not jeng.has_work
    assert len(payload["migrate"]) == 1 and not payload["resubmit"]
    assert bool(payload["draft_tiles"]) == (kind == "spec")
    dst = _port(nets, kind)
    out = dst.import_resident(payload)
    assert out[0]["migrated"] is True
    assert dst.run()[out[0]["rid"]] == ref["ref"]


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_midstream_port_to_jax(nets, jax_runs, kind):
    ref = jax_runs(kind)
    src = _port(nets, kind)
    _mid_stream(src, _prompt(MIGRANT[0], 7), MIGRANT[1])
    payload = json.loads(json.dumps(src.export_resident()))
    assert not src.has_work
    assert src.drain_stats() == {
        "draining": False, "resident_slots": 0, "prefilling": 0,
        "queued": 0, "blocks_remaining": 0,
    }
    jeng = ref["engine"]
    out = jeng.import_resident(payload)
    assert jeng.run()[out[0]["rid"]] == ref["ref"]
    assert src.obs.xfer_migrated.value({"dir": "out"}) == 1


def test_blocks_jax_to_port_and_back(nets, jax_runs):
    """JAX's blocks into the port: a 2-block prefix hit and the JAX
    exporter's tokens; the port's re-export of them into a fresh JAX
    engine likewise, with the same tile bytes."""
    p = _prompt(300, 31)
    jsrc = jax_runs("f32")["engine"]
    want = _serve(jsrc, p, 10)
    hashes = chain_hashes(p)
    payload = jsrc.export_blocks(hashes)
    assert [b["hash"] for b in payload["blocks"]] == hashes and len(hashes) == 2
    dst = _port(nets)
    assert dst.import_blocks(json.loads(json.dumps(payload))) == {
        "imported": 2, "rejected": {}}
    assert dst.obs.xfer_bytes.value({"dir": "in"}) == jsrc.obs.xfer_bytes.value(
        {"dir": "out"}) > 0
    back = dst.export_blocks(hashes)
    assert back["tiles"] == payload["tiles"]
    assert _serve(dst, p, 10) == want
    assert dst.prefix_stats()["block_hits"] == 2
    jdst = _jax(nets)
    assert jdst.import_blocks(back) == {"imported": 2, "rejected": {}}
    assert _serve(jdst, p, 10) == want
    assert jdst.prefix_stats()["block_hits"] == 2


def test_blocks_port_to_jax_with_divergent_tail(nets, jax_runs):
    p = _prompt(300, 32)
    src = _port(nets)
    want = _serve(src, p, 10)
    payload = src.export_blocks(chain_hashes(p))
    assert src.obs.xfer_exported.value() == 2
    jdst = jax_runs("f32")["engine"]
    assert jdst.import_blocks(payload) == {"imported": 2, "rejected": {}}
    assert _serve(jdst, p, 10) == want
    # A prompt that leaves the imported prefix after 256 tokens.
    p2 = np.concatenate([p[:256], _prompt(30, 77)])
    assert _serve(jdst, p2, 8) == _serve(_port(nets), p2, 8)


def test_bf16_tiles_round_trip_bytes(nets):
    """bf16 pools ship raw 2-byte words tagged "bfloat16": a JAX payload
    lands in the port's pools and leaves them byte for byte, and JAX
    reads the port's."""
    fields = dict(FIELDS, dtype="bfloat16")
    p = _prompt(300, 33)
    jsrc = JaxBatcher(jlm.LMConfig(**fields), nets["params"], **ENGINE)
    _serve(jsrc, p, 2)
    payload = jsrc.export_blocks(chain_hashes(p))
    assert payload["kv_dtype"] == "bfloat16"
    assert {t["dtype"] for t in payload["tiles"]} == {"bfloat16"}
    dst = ContinuousBatcher(tlm.LMConfig(**fields), nets["params"],
                            device="cpu", **ENGINE)
    assert dst._xfer_header() == jsrc._xfer_header()
    assert dst.import_blocks(payload)["imported"] == 2
    back = dst.export_blocks(chain_hashes(p))
    assert back["tiles"] == payload["tiles"]
    jdst = JaxBatcher(jlm.LMConfig(**fields), nets["params"], **ENGINE)
    assert jdst.import_blocks(back) == {"imported": 2, "rejected": {}}
    assert jdst.export_blocks(chain_hashes(p))["tiles"] == payload["tiles"]


def test_tile_order_is_the_jax_flatten_order(nets):
    """Twelve layers sort as block0, block1, block10, block11, block2...;
    int8 pools add the scale leaves."""
    fields = dict(FIELDS, num_layers=12, kv_dtype="int8")
    params = nets["params"] | {
        f"block{i}": nets["params"]["block0"] for i in range(12)}
    jeng = JaxBatcher(jlm.LMConfig(**fields), params, **ENGINE)
    leaves, _, kv = jeng._kv_leaves(jeng._state[0])
    flat, _ = jax.tree_util.tree_flatten_with_path(jeng._state[0])
    want = [(str(flat[i][0][0].key), name) for i, name in kv]
    eng = ContinuousBatcher(tlm.LMConfig(**fields), params, device="cpu",
                            **ENGINE)
    names = [name for name, _ in kv_leaves(eng._state.cache)]
    layer = sorted(range(12), key=lambda i: f"block{i}")
    assert [(f"block{layer[j // 4]}", n) for j, n in enumerate(names)] == want
    assert [tuple(leaves[i].shape[1:]) for i, _ in kv] == [
        tuple(t.shape[1:]) for _, t in kv_leaves(eng._state.cache)]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("knobs", [
    {}, {"temperature": 0.9, "top_k": 16, "top_p": 0.95, "seed": 123},
], ids=["greedy", "sampled"])
def test_port_to_port_midstream_is_exact(nets, knobs, bf16):
    fields = dict(FIELDS, dtype="bfloat16") if bf16 else FIELDS
    q = _prompt(*MIGRANT[:1], 7)

    def eng():
        return ContinuousBatcher(tlm.LMConfig(**fields), nets["params"],
                                 device="cpu", **ENGINE)

    ref = _serve(eng(), q, MIGRANT[1], **knobs)
    src = eng()
    _mid_stream(src, q, MIGRANT[1], **knobs)
    dst = eng()
    out = dst.import_resident(src.export_resident())
    assert dst.run()[out[0]["rid"]] == ref


def _slice_tiles(payload, rows):
    """The payload's tile records cut to block rows `rows`."""
    out = []
    for t in payload["tiles"]:
        n = t["shape"][0]
        raw = np.frombuffer(base64.b64decode(t["data"]), np.uint8).reshape(n, -1)
        out.append({**t, "shape": [len(rows)] + t["shape"][1:],
                    "data": base64.b64encode(raw[rows].tobytes()).decode("ascii")})
    return out


def test_rejections_carry_jax_reasons(nets):
    p = _prompt(300, 34)
    src = _port(nets)
    _serve(src, p, 2)
    payload = src.export_blocks(chain_hashes(p))
    orphan = {**payload, "blocks": payload["blocks"][1:],
              "tiles": _slice_tiles(payload, [1])}
    short = {**payload, "tiles": payload["tiles"][1:]}
    retyped = {**payload, "tiles": [{**payload["tiles"][0], "dtype": "int32"}]
               + payload["tiles"][1:]}
    cases = [
        ("dup", {}, [payload, payload]),
        ("orphan", {}, [orphan]),
        ("dry", dict(pool_blocks=2), [payload]),
        ("kv_dtype", dict(kind="int8"), [payload]),
        ("shape", {}, [short]),
        ("dtype", {}, [retyped]),
    ]
    for what, kw, payloads in cases:
        port, jax_eng = _port(nets, **kw), _jax(nets, **kw)
        got = [port.import_blocks(x) for x in payloads]
        want = [jax_eng.import_blocks(x) for x in payloads]
        assert got == want, what
        assert what in got[-1]["rejected"], (what, got)
        n = got[-1]["rejected"][what]
        assert port.obs.xfer_rejected.value({"reason": what}) == n
    with pytest.raises(RuntimeError, match="kv_dtype"):
        _port(nets, "int8").import_resident(
            {**payload, "kind": "resident", "migrate": [], "resubmit": []})


def test_queued_and_prefilling_export_as_resubmits(nets):
    src = _port(nets, slots=1)
    q1, q2 = _prompt(300, 11), _prompt(20, 12)
    src.submit(q1, max_new_tokens=6)
    src.submit(q2, max_new_tokens=5)
    src.step()  # q1 mid-prefill, q2 queued
    payload = src.export_resident()
    assert not src.has_work
    # The queue first, then the lane, as JAX orders them.
    assert [len(m["prompt"]) for m in payload["resubmit"]] == [20, 300]
    assert not payload["migrate"]
    assert src.pool.blocks_allocated() == 0 and src.pool.reserved == 0
    dst = _port(nets)
    dst.drain()  # resubmits pass the drain gate
    out = dst.import_resident(payload)
    res = dst.run()
    assert [res[o["rid"]] for o in out] == [
        _serve(_port(nets), q2, 5), _serve(_port(nets), q1, 6)]


def test_partial_export_leaves_other_streams_serving(nets):
    src = _port(nets)
    qa, qb = _prompt(140, 21), _prompt(150, 22)
    ra = src.submit(qa, max_new_tokens=20)
    rb = src.submit(qb, max_new_tokens=20)
    while not (src._requests[ra].tokens and src._requests[rb].tokens):
        src.step()
    assert sorted(src.decode_ready_rids()) == [ra, rb]
    payload = src.export_resident(only=[ra])
    assert len(payload["migrate"]) == 1 and not payload["resubmit"]
    assert list(payload["migrate"][0]["prompt"]) == list(qa)
    assert src.has_work
    dst = _port(nets)
    out = dst.import_resident(payload)
    moved = dst.run()[out[0]["rid"]]
    stayed = src.run()[rb]
    assert moved == _serve(_port(nets), qa, 20)
    assert stayed == _serve(_port(nets), qb, 20)


def test_drain_stats_count_down_and_import_is_all_or_nothing(nets):
    eng = _port(nets)
    rid = _mid_stream(eng, _prompt(140, 5), 30, steps=0)
    eng.drain()
    st = eng.drain_stats()
    assert st["draining"] is True and st["resident_slots"] == 1
    assert st["blocks_remaining"] >= 1
    payload = eng.export_resident()
    assert eng.drain_stats() == {
        "draining": True, "resident_slots": 0, "prefilling": 0,
        "queued": 0, "blocks_remaining": 0,
    }
    assert rid not in eng._requests
    full = _port(nets, slots=1)
    full.submit(_prompt(200, 6), max_new_tokens=30)
    full.step()
    before = full.drain_stats()
    with pytest.raises(RuntimeError, match="free slots"):
        full.import_resident(payload)
    assert full.drain_stats() == before


def test_migration_without_a_prefix_cache(nets):
    """prefix_cache=False on both sides: a mid-prefill request and a live
    one move, with no trie to unlink from or register in."""
    q1, q2 = _prompt(300, 41), _prompt(140, 42)
    src = _port(nets, prefix_cache=False)
    r2 = _mid_stream(src, q2, 20, steps=1)
    src.submit(q1, max_new_tokens=6)
    src.step()
    payload = src.export_resident()
    assert len(payload["migrate"]) == 1 and len(payload["resubmit"]) == 1
    assert src.pool.blocks_allocated() == 0 and not src.has_work
    dst = _port(nets, prefix_cache=False)
    out = {o["migrated"]: o["rid"] for o in dst.import_resident(payload)}
    res = dst.run()
    assert res[out[True]] == _serve(_port(nets), q2, 20)
    assert res[out[False]] == _serve(_port(nets), q1, 6)
    assert r2 not in src._requests
    with pytest.raises(RuntimeError, match="prefix_cache"):
        dst.export_blocks(chain_hashes(q1))
