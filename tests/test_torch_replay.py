"""The port's capture plane through its engine, and offline replay
(`models/serve.py` capture seams, `sim/replay.py`, `cmd/replay.py`,
`debug_state()`), against the JAX package's on the CPU.

The tiny f32 config of `tests/test_capture_replay.py` (1 layer, vocab
64) with bridged weights and its mixed greedy/sampled traffic:

- `config_fingerprint()` equals the JAX engine's dict, digest and id
  included, for a plain engine, int8 weights, spec with a draft, a
  synthetic LoRA set and the dense engine;
- a JAX greedy capture replays token for token in the port, and the
  port's in JAX's `replay_capture`; the port's mixed capture replays
  under JAX's override matrix (loop, prefix off, spec with an untrained
  draft, int8-sim);
- `classify_config_delta`, `first_divergence`, the truncated-record
  prefix rule, override rejections, triage verdicts and bundles, the
  CLI's exit codes and `parse_override` agree with JAX's; an MoE capture
  under capacity drops gets from the port whatever JAX says of it;
- `warm()` records nothing, a migrated request replays from the
  capture its importer wrote, and `debug_state()` equals JAX's key for
  key mid-run, less the `tp` block.

Sampled streams differ between the packages (counter-based Gumbel noise
against threefry bits), so cross-package replays are greedy. The JAX
engines get a private copy of every upload (`_dev`).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walkai_nos_tpu.cmd import replay as jcli
from walkai_nos_tpu.models import lm as jlm
from walkai_nos_tpu.models import lora as jlora
from walkai_nos_tpu.models.serve import ContinuousBatcher as JaxBatcher
from walkai_nos_tpu.sim import replay as jrep
from walkai_nos_tpu_torch.cmd import replay as tcli
from walkai_nos_tpu_torch.models import lm as tlm
from walkai_nos_tpu_torch.models import lora as tlora
from walkai_nos_tpu_torch.models.convert import served_tree
from walkai_nos_tpu_torch.models.serve import ContinuousBatcher
from walkai_nos_tpu_torch.obs import capture as tcap
from walkai_nos_tpu_torch.sim import replay as trep

torch.set_num_threads(1)

FIELDS = dict(vocab_size=64, hidden_dim=32, num_layers=1, num_heads=2,
              max_seq_len=320, dtype="float32")
ENGINE = dict(slots=2, cache_len=256, prompt_bucket=16, chunk_steps=2)


def _jax_dev(self, a):
    return jnp.asarray(np.array(a, copy=True))


@pytest.fixture(scope="module", autouse=True)
def _jax_copies():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxBatcher, "_dev", _jax_dev)
        yield


def _init(seed, **changes):
    cfg = jlm.LMConfig(**{**FIELDS, **changes})
    return jax.device_get(jlm.DecoderLM(cfg).init_params(jax.random.PRNGKey(seed)))


@pytest.fixture(scope="module")
def params():
    return _init(0)


def _traffic(engine, greedy=False):
    """JAX's `_mixed_traffic`: ragged greedy and sampled submissions, one
    prompt crossing the 128-row block boundary, EOS-terminating budgets;
    `greedy` sets every temperature to 0."""
    rng = np.random.default_rng(0)
    rids = []
    for plen, temperature in (
        (3, 0.0), (140, 0.0), (5, 1.0), (9, 1.0), (130, 1.0), (4, 0.0),
    ):
        rids.append(engine.submit(
            rng.integers(0, FIELDS["vocab_size"], plen).tolist(),
            max_new_tokens=int(rng.integers(3, 9)),
            eos_id=3,
            temperature=0.0 if greedy else temperature,
        ))
    return rids


def _record(engine, greedy=False):
    _traffic(engine, greedy)
    records = {}
    while engine.has_work:
        engine.step()
        records.update(engine.drain_done_records())
    records.update(engine.drain_done_records())
    return records


def _port(params, cfg=None, **kw):
    return ContinuousBatcher(cfg or tlm.LMConfig(**FIELDS), params,
                             device="cpu", **{**ENGINE, **kw})


def _jax(params, cfg=None, **kw):
    return JaxBatcher(cfg or jlm.LMConfig(**FIELDS), params, **{**ENGINE, **kw})


def _json(obj):
    return json.loads(json.dumps(obj, default=str))


@pytest.fixture(scope="module")
def captures(params, tmp_path_factory):
    """The captured runs every replay shares: the port's mixed run, and a
    greedy run in each package."""
    out = {}
    for name, build, greedy in (("port", _port, False),
                                ("port_greedy", _port, True),
                                ("jax_greedy", _jax, True)):
        d = str(tmp_path_factory.mktemp(name))
        engine = build(params, capture=d)
        records = _record(engine, greedy)
        out[name] = {"dir": d, "records": records,
                     "fingerprint": engine.config_fingerprint()}
    return out


# -- the fingerprint ---------------------------------------------------------

def _variant(name):
    """(JAX engine kwargs, port engine kwargs, cfg changes) of a variant."""
    if name == "spec":
        dcfg = jlm.draft_config(jlm.LMConfig(**FIELDS))
        dparams = jax.device_get(jlm.DecoderLM(dcfg).init_params(jax.random.PRNGKey(1)))
        return (dict(spec=True, spec_k=3, draft_params=dparams,
                     draft_cfg=jlm.draft_config(jlm.LMConfig(**FIELDS))),
                dict(spec=True, spec_k=3, draft_params=dparams,
                     draft_cfg=tlm.draft_config(tlm.LMConfig(**FIELDS))), {})
    if name == "lora":
        return (dict(adapters=jlora.AdapterSet.synthetic(
                    jlm.LMConfig(**FIELDS), k=3, rank=2, seed=5)),
                dict(adapters=tlora.AdapterSet.synthetic(
                    tlm.LMConfig(**FIELDS), k=3, rank=2, seed=5)), {})
    if name == "int8":
        return {}, {}, {"w_dtype": "int8"}
    if name == "dense":
        return dict(paged=False), dict(paged=False), {}
    return {}, {}, {}


@pytest.mark.parametrize("name", ["plain", "int8", "spec", "lora", "dense"])
def test_config_fingerprint_equals_jax(params, name):
    jkw, tkw, changes = _variant(name)
    jfp = _jax(params, jlm.LMConfig(**{**FIELDS, **changes}), **jkw).config_fingerprint()
    tfp = _port(params, tlm.LMConfig(**{**FIELDS, **changes}), **tkw).config_fingerprint()
    assert _json(tfp) == _json(jfp)
    assert tfp["id"] == jfp["id"] == tcap.fingerprint_id(tfp)


@pytest.mark.parametrize("w_dtype", ["model", "int8", "int8-sim"])
def test_weights_digest_reads_jax_leaves(params, w_dtype):
    """The leaves the port digests (`served_tree` of its `DecoderLM`) are
    the JAX engine's served tree's: paths, dtypes, shapes and bytes,
    int8 kernels beside their f32 scale rows included."""
    jeng = _jax(params, jlm.LMConfig(**FIELDS, w_dtype=w_dtype))
    teng = _port(params, tlm.LMConfig(**FIELDS, w_dtype=w_dtype))
    want = [
        (jax.tree_util.keystr(p), str(np.asarray(a).dtype), np.asarray(a).shape)
        for p, a in sorted(jax.tree_util.tree_leaves_with_path(jeng.params),
                           key=lambda kv: jax.tree_util.keystr(kv[0]))
    ]
    got = sorted(
        (tcap._keystr(p), str(t.dtype).removeprefix("torch."), tuple(t.shape))
        for p, t in tcap._leaves_with_path(served_tree(teng.model))
    )
    assert got == want
    if w_dtype == "int8":
        assert ("['block0']['attn']['qkv']['scale']", "float32", (96,)) in got
    assert tcap.tree_crc32(served_tree(teng.model)) == tcap.tree_crc32(
        jax.device_get(jeng.params))


def test_uncaptured_engine_never_reads_its_weights(params, monkeypatch):
    from walkai_nos_tpu_torch.models import serve as tserve

    def refuse(tree):
        raise AssertionError("an unarmed engine digested its weights")

    monkeypatch.setattr(tserve, "tree_crc32", refuse)
    engine = _port(params)
    assert engine.fingerprint_id is None
    engine.submit([1, 2], max_new_tokens=2)
    engine.run()
    recs = engine.drain_done_records()
    assert all(r["fingerprint"] is None for r in recs.values())
    assert engine.capture_stats() == {"enabled": False, "fingerprint": None}
    assert engine.capture is None


def test_capture_is_accepted_and_obs_still_refused(params, tmp_path):
    engine = _port(params, capture=str(tmp_path))
    assert isinstance(engine.capture, tcap.CaptureLog)
    assert engine.capture_stats()["fingerprint"] == engine.fingerprint_id
    with pytest.raises(ValueError, match="capture must be"):
        _port(params, capture=12345)
    # The obs planes' SLO windows are ported: JAX's options and errors.
    assert _port(params, slo_window_s=5.0).slo_stats()["window_s"] == 5.0
    with pytest.raises(ValueError, match="unknown SLO objective"):
        _port(params, slo_objectives={"ttft_s": 1.0})


def test_jax_paged_prompt_bucket_capture_replays_in_the_port(tmp_path):
    """A JAX paged engine at `prompt_bucket=64` (LM_TINY's widths in f32,
    2 slots, cache_len 128; the demo server's bucket): the port builds
    the same engine, with an equal fingerprint, and replays the capture
    token for token."""
    import dataclasses

    jcfg = dataclasses.replace(jlm.LM_TINY, dtype="float32")
    tcfg = dataclasses.replace(tlm.LM_TINY, dtype="float32")
    weights = jax.device_get(
        jlm.DecoderLM(jcfg).init_params(jax.random.PRNGKey(3)))
    kw = dict(slots=2, cache_len=128, prompt_bucket=64)
    jeng = JaxBatcher(jcfg, weights, capture=str(tmp_path), **kw)
    rng = np.random.default_rng(3)
    for n, m in ((5, 9), (70, 12), (40, 20)):
        jeng.submit(rng.integers(0, jcfg.vocab_size, n).tolist(), max_new_tokens=m)
    jeng.run()
    port = ContinuousBatcher(tcfg, weights, device="cpu", **kw)
    assert port.config_fingerprint() == jeng.config_fingerprint()
    cap = trep.load_capture(str(tmp_path))
    assert cap.fingerprint["engine"]["prompt_bucket"] == 64
    report = trep.replay_capture(cap, weights, device="cpu")
    assert report.ok, report.summary()
    assert report.n_verified == len(cap.records) == 3


def test_load_adapter_resets_the_fingerprint(params):
    cfg = tlm.LMConfig(**FIELDS)
    engine = _port(params, adapters=tlora.AdapterSet.synthetic(cfg, k=3, rank=2))
    first = engine.config_fingerprint()
    engine.unload_adapter(2)
    second = engine.config_fingerprint()
    assert second["id"] != first["id"]
    assert second["lora"]["adapters"] != first["lora"]["adapters"]


# -- capture and replay ------------------------------------------------------

def test_capture_matches_live_run(captures):
    run = captures["port"]
    cap = trep.load_capture(run["dir"])
    assert cap.fingerprint == run["fingerprint"]
    assert {r.rid: r.tokens for r in cap.records} == {
        rid: rec["tokens"] for rid, rec in run["records"].items()
    }
    for r in cap.records:
        assert r.digest == tcap.token_digest(r.tokens)
        assert r.seed == r.rid  # the effective seed
    for rec in run["records"].values():
        assert rec["fingerprint"] == run["fingerprint"]["id"]


def test_captures_are_byte_compatible(captures):
    """The same greedy run captured by each package: equal fingerprints,
    and record for record the same fields and values, clocks aside."""
    clocks = ("arrival_s", "ttft_s", "wall_s", "created_unix_s")

    def rows(d):
        out = []
        for path in sorted(os.listdir(d)):
            with open(os.path.join(d, path)) as f:
                for line in f:
                    obj = json.loads(line)
                    out.append({k: v for k, v in obj.items() if k not in clocks})
        return out

    assert rows(captures["port_greedy"]["dir"]) == rows(captures["jax_greedy"]["dir"])


def test_jax_capture_replays_in_the_port(captures, params):
    cap = trep.load_capture(captures["jax_greedy"]["dir"])
    report = trep.replay_capture(cap, params, device="cpu")
    assert report.ok, report.summary()
    assert report.n_verified == len(cap.records) == 6


def test_port_capture_replays_in_jax(captures, params):
    cap = jrep.load_capture(captures["port_greedy"]["dir"])
    report = jrep.replay_capture(cap, params)
    assert report.ok, report.summary()
    assert report.n_verified == len(cap.records) == 6


@pytest.mark.parametrize(
    "overrides",
    [None, {"loop_steps": 8}, {"prefix_cache": False},
     {"spec": True, "spec_min_accept": 0.0}, {"kv_dtype": "int8-sim"}],
    ids=["same", "loop8", "prefix-off", "spec-untrained-draft", "int8-sim"],
)
def test_replay_token_identical(captures, params, overrides):
    cap = trep.load_capture(captures["port"]["dir"])
    report = trep.replay_capture(cap, params, overrides=overrides, device="cpu")
    assert report.ok, report.summary()
    assert report.n_verified == len(cap.records)
    for rec in cap.records:
        assert report.outcomes[rec.rid].tokens == rec.tokens


def test_replay_from_a_model_rebinds_to_the_override(captures, params):
    """A `DecoderLM` handed to a replay whose override changes its config
    (int8-sim KV: the same parameters; int8 weights: quantized from a
    host copy) serves the replay's config."""
    cap = trep.load_capture(captures["port"]["dir"])
    model = tlm.DecoderLM.from_params(tlm.LMConfig(**FIELDS), params, "cpu")
    report = trep.replay_capture(cap, model, overrides={"kv_dtype": "int8-sim"},
                                 device="cpu")
    assert report.ok, report.summary()
    eng = trep.build_engine(cap.fingerprint, model, overrides={"w_dtype": "int8"},
                            device="cpu")
    want = _port(params, tlm.LMConfig(**FIELDS, w_dtype="int8"))
    assert eng.config_fingerprint()["weights_crc32"] == (
        want.config_fingerprint()["weights_crc32"])


def test_original_timing_replay(captures, params):
    cap = trep.load_capture(captures["port"]["dir"])
    report = trep.replay_capture(cap, params, timing="original", speed=1000.0,
                                 device="cpu")
    assert report.ok, report.summary()
    assert report.n_verified == len(cap.records)
    with pytest.raises(ValueError, match="timing must be"):
        trep.replay_capture(cap, params, timing="later", device="cpu")


def test_truncated_record_verifies_by_prefix(captures, params, tmp_path):
    src = trep.load_capture(captures["port"]["dir"])
    lines, chopped = [], False
    for path in src.files:
        for line in open(path):
            obj = json.loads(line)
            if (not chopped and obj.get("kind") == "done"
                    and len(obj.get("tokens") or []) > 1):
                obj["tokens"] = obj["tokens"][:-1]
                obj["n_tokens"] = len(obj["tokens"])
                obj["truncated"] = True
                obj["reason"] = "pool_overflow"
                chopped = True
            lines.append(json.dumps(obj))
    assert chopped
    edited = tmp_path / "capture-000001.jsonl"
    edited.write_text("\n".join(lines) + "\n")
    for rep in (trep, jrep):
        assert rep.load_capture(str(edited)).records[0].truncated in (True, False)
    report = trep.replay_capture(trep.load_capture(str(edited)), params,
                                 device="cpu")
    assert report.ok, report.summary()


def test_override_rejections(captures):
    fp = captures["port"]["fingerprint"]
    msgs = []
    for rep in (jrep, trep):
        with pytest.raises(ValueError, match="unknown override") as err:
            rep.build_config(fp, {"not_a_knob": 1})
        msgs.append(str(err.value))
        with pytest.raises(ValueError, match="no cfg/engine"):
            rep.build_config({"router": {}}, None)
    assert msgs[0] == msgs[1]
    # What the port has not ported raises; the replay never runs without it.
    for knob in ({"tp_devices": 2}, {"use_ring_attention": True}):
        with pytest.raises(NotImplementedError):
            trep.build_engine(fp, {}, overrides=knob, device="cpu")


def test_build_engine_and_cli_default_to_the_gpu(captures, params):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-GPU refusal cannot be shown")
    fp = captures["port"]["fingerprint"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trep.build_engine(fp, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main([captures["port"]["dir"]])
    assert tcli.parse_args(["x"]).device == "cuda"
    assert trep.build_engine(fp, params, device="cpu").device.type == "cpu"


def _pairs(captures):
    base = captures["port"]["fingerprint"]

    def edit(section, **changes):
        fp = json.loads(json.dumps(base))
        fp[section].update(changes)
        return fp

    return [
        (base, base),
        (base, edit("engine", loop_steps=8, prefix_cache=False)),
        (base, edit("cfg", kv_dtype="int8-sim", w_dtype="int8-sim")),
        (base, edit("cfg", kv_dtype="int8")),
        (base, edit("cfg", hidden_dim=64)),
        (base, edit("cfg", tp_devices=2)),
        (base, edit("engine", mystery=1)),
        (base, {**base, "lora": {"digests": {"1": 2}}}),
        ({}, base),
    ]


def test_classify_config_delta_matches_jax(captures):
    for a, b in _pairs(captures):
        assert trep.classify_config_delta(a, b) == jrep.classify_config_delta(a, b)
    moving = [trep.classify_config_delta(a, b)["token_preserving"]
              for a, b in _pairs(captures)]
    assert moving == [True, True, True, False, False, True, False, False, False]


@pytest.mark.parametrize("expected,got", [
    ([1, 2, 3], [1, 2, 3]), ([1, 2, 3], [1, 5, 3]), ([1, 2], [1, 2, 3]),
    ([1, 2, 3], [1]), ([], [4]), ([7], [8]),
])
def test_first_divergence_matches_jax(expected, got):
    assert trep.first_divergence(expected, got) == jrep.first_divergence(expected, got)


# -- triage -------------------------------------------------------------------

def _bundle(path):
    with open(path) as f:
        bundle = json.load(f)
    state = bundle.pop("debug_state")
    return bundle, state


@pytest.fixture(scope="module")
def divergent(captures, tmp_path_factory):
    """The JAX greedy capture replayed under other weights, triaged by
    each package."""
    params2 = _init(1)
    out = {}
    for pkg, rep, kw in (("jax", jrep, {}), ("port", trep, {"device": "cpu"})):
        cap = rep.load_capture(captures["jax_greedy"]["dir"])
        report = rep.replay_capture(cap, params2, **kw)
        verdict = rep.triage_divergence(
            cap, report, params2, flight_dir=str(tmp_path_factory.mktemp(pkg)), **kw)
        out[pkg] = (cap, report, verdict)
    return out


def test_triage_config_dependent_equals_jax(divergent):
    (_, jreport, jverdict), (cap, report, verdict) = divergent["jax"], divergent["port"]
    assert not report.ok
    assert report.divergent == jreport.divergent
    assert report.divergent[0] == cap.records[0].rid
    assert verdict["classification"] == "config_dependent"
    strip = lambda v: {k: x for k, x in v.items() if k != "bundle_path"}  # noqa: E731
    assert strip(verdict) == strip(jverdict)
    rec = cap.records[0]
    out = report.outcomes[verdict["rid"]]
    idx = verdict["token_index"]
    assert rec.tokens[:idx] == out.tokens[:idx]
    assert verdict["expected_token"] == rec.tokens[idx]
    assert verdict["got_token"] == out.tokens[idx]


def test_flight_bundle_equals_jax(divergent):
    jbundle, jstate = _bundle(divergent["jax"][2]["bundle_path"])
    bundle, state = _bundle(divergent["port"][2]["bundle_path"])
    assert bundle["trigger"] == "replay_divergence"
    assert bundle == jbundle
    assert (bundle["replay_fingerprint"]["weights_crc32"]
            != bundle["capture_fingerprint"]["weights_crc32"])
    assert set(state) == set(jstate)


def test_triage_none_on_clean_replay(captures, params):
    cap = trep.load_capture(captures["port"]["dir"])
    report = trep.replay_capture(cap, params, device="cpu")
    assert trep.triage_divergence(cap, report, params, device="cpu") is None


def test_solo_match_classifies_batch_dependent(captures, params, tmp_path):
    """A fabricated divergence (the solo re-run under the true config
    reproduces the capture): triage must say batch_dependent, as JAX's."""
    verdicts = {}
    for pkg, rep, kw in (("jax", jrep, {}), ("port", trep, {"device": "cpu"})):
        cap = rep.load_capture(captures["jax_greedy"]["dir"])
        report = rep.replay_capture(cap, params, **kw)
        assert report.ok
        victim = cap.records[0]
        out = report.outcomes[victim.rid]
        out.match = False
        out.tokens = list(out.tokens)
        out.tokens[-1] = (out.tokens[-1] + 1) % FIELDS["vocab_size"]
        out.first_divergent_token = len(out.tokens) - 1
        report.divergent = [victim.rid]
        verdict = rep.triage_divergence(cap, report, params,
                                        flight_dir=str(tmp_path / pkg), **kw)
        verdicts[pkg] = {k: v for k, v in verdict.items() if k != "bundle_path"}
    assert verdicts["port"]["classification"] == "batch_dependent"
    assert verdicts["port"] == verdicts["jax"]


MOE = dict(vocab_size=64, hidden_dim=64, num_layers=2, num_heads=4,
           num_kv_heads=2, mlp_dim=96, max_seq_len=320, dtype="float32",
           norm="rmsnorm", mlp="swiglu", rope=True, use_bias=False,
           head_bias=False, layer_norm_eps=1e-5, num_experts=4, moe_every=2,
           expert_top_k=2, capacity_factor=1.25)


def test_moe_capture_under_drops_replays_as_in_jax(tmp_path):
    """An MoE model whose capacity drops tokens: its output depends on the
    batch in both packages, so a replay at another batch composition may
    diverge. Whatever JAX's replay and triage say of its capture (the
    prefix cache off, and a fold of 8), the port says the same."""
    cfg = jlm.LMConfig(**MOE)
    mparams = jax.device_get(jax.jit(jlm.DecoderLM(cfg).init_params)(
        jax.random.PRNGKey(3)))
    d = str(tmp_path / "cap")
    _record(JaxBatcher(cfg, mparams, capture=d, **ENGINE), greedy=True)
    for overrides in ({"prefix_cache": False, "slots": 3}, {"loop_steps": 8}):
        said = {}
        for pkg, rep, kw in (("jax", jrep, {}), ("port", trep, {"device": "cpu"})):
            cap = rep.load_capture(d)
            report = rep.replay_capture(cap, mparams, overrides=overrides, **kw)
            verdict = rep.triage_divergence(
                cap, report, mparams, overrides=overrides,
                flight_dir=str(tmp_path / pkg), **kw)
            summary = {k: v for k, v in report.summary().items()
                       if k != "replay_wall_s"}
            tokens = {rid: o.tokens for rid, o in report.outcomes.items()}
            said[pkg] = (summary, tokens, verdict and {
                k: v for k, v in verdict.items() if k != "bundle_path"})
        assert said["port"] == said["jax"], overrides


# -- the CLI -------------------------------------------------------------------

@pytest.fixture(scope="module")
def seeded_capture(tmp_path_factory):
    """A capture of the port's `DecoderLM(cfg, seed=0)` on the CPU: what
    the CLI rebuilds from `--init-seed 0 --device cpu`."""
    d = str(tmp_path_factory.mktemp("seeded"))
    cfg = tlm.LMConfig(**FIELDS)
    engine = _port(tlm.DecoderLM(cfg, device="cpu", seed=0), capture=d)
    _record(engine)
    return d


def test_cli_exit_codes(seeded_capture, tmp_path, capsys):
    assert tcli.main([seeded_capture, "--init-seed", "0", "--device", "cpu",
                      "--json"]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["ok"] and summary["verified"] == 6 and not summary["notes"]
    flight = tmp_path / "flt"
    assert tcli.main([seeded_capture, "--init-seed", "7", "--device", "cpu",
                      "--flight-dir", str(flight)]) == 1
    out = capsys.readouterr().out
    assert "config_dependent" in out and "weights digest mismatch" in out
    assert any(n.startswith("flight-") for n in os.listdir(flight))


def test_cli_digest_warning_survives_engine_knob_override(seeded_capture,
                                                          tmp_path, capsys):
    rc = tcli.main([seeded_capture, "--init-seed", "7", "--device", "cpu",
                    "--override", "loop_steps=1", "--flight-dir", str(tmp_path)])
    assert rc == 1
    assert "weights digest mismatch" in capsys.readouterr().out


def test_cli_notes_a_jax_capture(captures, tmp_path, capsys):
    """The port's seeded weights are not JAX's: a JAX capture fails the
    digest here and says so, as JAX's CLI does on other weights."""
    rc = tcli.main([captures["jax_greedy"]["dir"], "--device", "cpu",
                    "--flight-dir", str(tmp_path)])
    assert rc == 1
    assert "weights digest mismatch" in capsys.readouterr().out


@pytest.mark.parametrize("text", [
    "loop_steps=8", "prefix_cache=false", "spec=TRUE", "kv_dtype=int8-sim",
    "spec_min_accept=0.5", "x=1e-3", "name= spaced ", "a=b=c",
])
def test_cli_override_parsing_matches_jax(text):
    assert tcli.parse_override(text) == jcli.parse_override(text)


def test_cli_override_needs_an_equals_sign():
    import argparse

    for cli in (tcli, jcli):
        with pytest.raises(argparse.ArgumentTypeError):
            cli.parse_override("loop_steps")
    t, j = tcli.parse_args(["c", "--run", "-1"]), jcli.parse_args(["c", "--run", "-1"])
    assert {k: v for k, v in vars(t).items() if k != "device"} == vars(j)


# -- engine seams ----------------------------------------------------------------

def test_warm_leaves_the_capture_empty(params, tmp_path):
    engine = _port(params, capture=str(tmp_path))
    engine.warm()
    assert engine.capture_stats()["records"] == {"submit": 0, "done": 0}
    rid = engine.submit([5, 6, 7], max_new_tokens=3)
    engine.run()
    assert engine.capture_stats()["records"] == {"submit": 1, "done": 1}
    cap = trep.load_capture(str(tmp_path))
    assert [r.rid for r in cap.records] == [rid]


def test_migrated_request_replays_from_its_capture(params, tmp_path):
    """A request exported mid-stream lands in an importer that captures:
    its submit record (effective seed) and done record replay the whole
    stream from the prompt, greedy and sampled."""
    src = _port(params)
    rng = np.random.default_rng(4)
    knobs = ({}, {"temperature": 0.9, "top_k": 20})
    rids = [src.submit(rng.integers(0, 64, n).tolist(), max_new_tokens=12, **kw)
            for n, kw in zip((140, 30), knobs)]
    while not all(len(src._requests[r].tokens) > 2 for r in rids):
        src.step()
    payload = json.loads(json.dumps(src.export_resident()))
    assert len(payload["migrate"]) == 2
    dst = _port(params, capture=str(tmp_path))
    landed = dst.import_resident(payload)
    done = dst.run()
    assert {o["rid"] for o in landed} == set(done)
    cap = trep.load_capture(str(tmp_path))
    assert len(cap.records) == 2 and all(r.tokens for r in cap.records)
    report = trep.replay_capture(cap, params, device="cpu")
    assert report.ok, report.summary()
    assert report.n_verified == 2


def _state_schedule(engine):
    """Submit three requests and step four turns: two prefilling or
    decoding, one queued."""
    rng = np.random.default_rng(9)
    for n, m in ((140, 9), (20, 12), (50, 6)):
        engine.submit(rng.integers(0, 64, n).tolist(), max_new_tokens=m)
    for _ in range(4):
        engine.step()


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_debug_state_equals_jax(params, tmp_path, paged):
    """At the same point of the same run, JAX's `debug_state()` and the
    port's hold the same keys and the same values in the engine's own
    books (slots, prefilling, pool, queue, prefix, spec, loop, tp at one
    card, sp, LoRA, the capture's tallies, and what
    of the attribution and SLO blocks does not depend on wall time)."""
    # An SLO window longer than any run here, so the windows hold every
    # sample however slow the host.
    kw = dict(paged=paged, slo_window_s=3600.0, **({} if paged else {"slots": 3}))
    jeng = _jax(params, capture=str(tmp_path / "jax"), **kw)
    teng = _port(params, capture=str(tmp_path / "port"), **kw)
    for eng in (jeng, teng):
        # The SLO layer refreshes at every sync, not once a second of
        # wall time: its saturation components then read the same sync.
        eng._slo.refresh_s = 0.0
        _state_schedule(eng)
    # One snapshot each: the SLO block's spans and quantiles read the clock.
    state = teng.debug_state()
    want, got = _json(jeng.debug_state()), _json(state)
    assert list(got) == list(want)
    for key in got:
        assert set(got[key]) == set(want[key]) if isinstance(got[key], dict) else True
    for key in ("paged", "queue_depth", "has_work", "slots", "prefilling", "pool",
                "prefix", "spec", "loop", "tp", "sp", "lora"):
        assert got[key] == want[key], key
    for key in ("enabled", "fingerprint", "records", "dropped", "max_bytes",
                "max_files", "files"):
        assert got["capture"][key] == want["capture"][key], key
    for key in ("enabled", "kv_dtype", "w_dtype", "kv_bytes_per_token"):
        assert got["quant"][key] == want["quant"][key], key
    for key in ("roofline_fraction", "hbm_bytes_per_step", "window_dispatches"):
        assert got["attrib"][key] == want["attrib"][key], key
    assert ({k: v["dispatches"] for k, v in got["attrib"]["kinds"].items()}
            == {k: v["dispatches"] for k, v in want["attrib"]["kinds"].items()})
    for key in ("window_s", "objectives", "slo_ok", "ok", "burn_rate"):
        assert got["slo"][key] == want["slo"][key], key
    assert ({k: w["count"] for k, w in got["slo"]["windows"].items()}
            == {k: w["count"] for k, w in want["slo"]["windows"].items()})
    comps, jcomps = (d["slo"]["saturation"]["components"] for d in (got, want))
    for key in ("busy", "queue", "pool"):
        assert comps[key] == jcomps[key], key
    assert json.loads(json.dumps(state)) == got
