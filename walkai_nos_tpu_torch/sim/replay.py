"""Offline re-execution of capture logs and first-divergence triage.

Port of `walkai_nos_tpu/sim/replay.py`, the read side of the capture
plane (`obs/capture.py`): load a capture, rebuild the serving engine
from its config fingerprint (or from the fingerprint plus explicit knob
overrides, e.g. replay a bf16 capture under `kv_dtype=int8-sim`),
re-submit the recorded requests with their original knobs and EFFECTIVE
seeds, and verify every completion digest. Because serving output is a
function of (weights, prompt, knobs, seed) alone, whatever the batch
composition, chunking, loop folding, spec rounds or quantization-sim, a
faithful replay is token-identical however the replayed batch composes,
and every determinism-preserving override (loop depth, prefix cache on
or off, speculative on or off with any draft, int8-sim) verifies clean
too. A divergence therefore means something real: changed weights, a
config axis that moves the function, or a violated engine invariant.
(Speculative rounds keep spec-off tokens in exact arithmetic only: a
bf16 verify rounds apart from one-step decodes at near-ties, in both
packages, so a bf16 spec axis can diverge without a fault.)

On mismatch, `triage_divergence` isolates the FIRST divergent request
(arrival order) and re-runs it SOLO on a fresh engine to classify it:

- solo output == captured output -> **batch_dependent**: the request
  alone still reproduces the capture, so the divergence appears only
  under batch composition: a violated engine invariant (an engine bug);
- solo output != captured output -> **config_dependent**: the rebuilt
  (weights, config) pair computes a different function.

It reports the first divergent token and dumps a flight bundle
(`obs/anomaly.FlightRecorder`): both configs' fingerprints, the
offending record, the divergence coordinates and the solo engine's
`debug_state()`. `python -m walkai_nos_tpu_torch.cmd.replay CAPTURE`
runs both in one command.

Timing: `timing="asap"` re-submits in arrival order as fast as the
engine admits (digest verification, the default); `timing="original"`
re-paces submissions to the recorded arrival offsets (scaled by
`speed`).

What differs from the JAX module: `params` is a `DecoderLM` (or the
JAX package's flax tree as numpy arrays, bridged by
`models/convert.py`); a spec replay's untrained draft is
`DecoderLM(draft_cfg, seed=draft_seed)`; `build_engine` takes the
engine's `device` (None: `cuda`). A `DecoderLM` built for a config that
differs from the replay's only where the weights do not (`kv_dtype`,
`fused_qkv`) is rebound to the replay's config over the same tensors'
values; a `w_dtype` override quantizes a host copy of its weights. An
override the port has not ported (`tp_devices > 1`, the ring and
ulysses flags) raises its NotImplementedError. Captures of either
package load here, and the port's load in the JAX package.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import time
from dataclasses import dataclass, field

__all__ = [
    "Capture",
    "CaptureRecord",
    "ReplayReport",
    "build_config",
    "build_engine",
    "classify_config_delta",
    "first_divergence",
    "load_capture",
    "replay_capture",
    "triage_divergence",
]

# ContinuousBatcher constructor knobs a fingerprint's `engine` section
# records (everything else in an override targets an LMConfig field).
ENGINE_KNOBS = (
    "slots", "cache_len", "prompt_bucket", "chunk_steps",
    "loop_steps", "paged", "pool_blocks", "prefill_chunk",
    "prefill_lanes", "prefix_cache", "spec", "spec_k",
    "spec_min_accept", "spec_warmup_rounds", "spec_ema_alpha",
    "sp_prefill", "sp_min_tokens", "sp_span",
)

# LMConfig fields whose change preserves token VALUES (the purity
# invariant the replay plane pins): tp degree is proven
# token-identical to tp=1; kv_dtype/w_dtype count separately because
# only SOME transitions preserve tokens (see classify_config_delta).
TOKEN_PRESERVING_CFG_FIELDS = ("tp_devices",)

# Dtype values whose pairwise transitions keep the serving function:
# "int8-sim" runs identity quantization with unit scales, so it is
# token-identical to "model" by construction; real "int8" rounds.
_TOKEN_PRESERVING_DTYPES = frozenset({"model", "int8-sim"})


def classify_config_delta(fp_a: dict, fp_b: dict) -> dict:
    """Classify the config delta between two engine fingerprints (the
    canary plane's up-front gate decision in the JAX package): is the
    candidate config expected to produce IDENTICAL token streams
    (digest-exact gate armed) or does a delta field move the serving
    function (latency-only comparison)?

    Compares the fingerprints' `cfg` and `engine` sections
    field-by-field — NOT the weights digest: the digest gate exists
    precisely to catch a weights change the config delta cannot
    explain (same knobs, different checkpoint -> gate armed ->
    divergence -> reject). A delta field is token-preserving when it
    is an engine knob (every ENGINE_KNOBS axis is a
    determinism-preserving replay override), a known-safe LMConfig
    field (`tp_devices`), or a kv_dtype/w_dtype transition within
    {"model", "int8-sim"}; anything else — model dims, vocab, real
    int8 — declares the configs different functions.

    Returns `{"delta": [{"section", "field", "a", "b"}, ...],
    "token_preserving": bool, "moving_fields": [...]}`; an empty
    delta (identical configs) is trivially token-preserving."""
    delta: list[dict] = []
    moving: list[str] = []
    for section in ("cfg", "engine"):
        a = dict((fp_a or {}).get(section) or {})
        b = dict((fp_b or {}).get(section) or {})
        for field_name in sorted(set(a) | set(b)):
            va, vb = a.get(field_name), b.get(field_name)
            if va == vb:
                continue
            delta.append({
                "section": section, "field": field_name,
                "a": va, "b": vb,
            })
            if section == "engine":
                if field_name in ENGINE_KNOBS:
                    continue
            elif field_name in TOKEN_PRESERVING_CFG_FIELDS:
                continue
            elif field_name in ("kv_dtype", "w_dtype") and {
                va, vb
            } <= _TOKEN_PRESERVING_DTYPES:
                continue
            moving.append(f"{section}.{field_name}")
    # The multi-LoRA plane (fp["lora"], adapter digests + recipe): a
    # differing adapter set computes a different function for every
    # request routed at the changed ids — conservatively
    # function-moving, like a weights delta.
    lora_a = (fp_a or {}).get("lora")
    lora_b = (fp_b or {}).get("lora")
    if lora_a != lora_b:
        delta.append({
            "section": "lora", "field": "adapters",
            "a": lora_a, "b": lora_b,
        })
        moving.append("lora.adapters")
    return {
        "delta": delta,
        "token_preserving": not moving,
        "moving_fields": moving,
    }


@dataclass
class CaptureRecord:
    """One captured request: the submit-side inputs (always present)
    merged with the done-side outputs (None until the request
    completed inside the retained capture window)."""

    rid: int
    prompt: list
    max_new_tokens: int = 1
    eos_id: int | None = None
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int | None = None
    adapter: int = 0  # multi-LoRA adapter id (0 = base model)
    arrival_s: float = 0.0
    trace_id: str | None = None
    replica: str | None = None
    tokens: list | None = None
    digest: str | None = None
    ttft_s: float | None = None
    wall_s: float | None = None
    truncated: bool = False
    reason: str | None = None
    error: str | None = None  # fleet captures: failed replica request
    # Fleet captures: True on the shadow copy a canary-armed router
    # mirrored to its candidate replica. Mirrored rows never represent
    # user traffic — load_capture drops them by default so a replay
    # of a canary-armed window does not double-count every sampled
    # request.
    mirrored: bool = False


@dataclass
class Capture:
    fingerprint: dict
    records: list[CaptureRecord]  # arrival order
    skipped: int  # malformed lines + orphan done records
    files: list[str]
    runs: int = 1  # engine runs found in the file set
    run: int = 0  # which run this Capture holds (0-based)
    mirrored_skipped: int = 0  # canary shadow rows dropped at load

    @property
    def fingerprint_id(self) -> str | None:
        return (self.fingerprint or {}).get("id")


def load_capture(
    path: str,
    *,
    run: int | None = None,
    include_mirrored: bool = False,
) -> Capture:
    """Parse a capture file, or a directory of rotated capture files
    (oldest first — each file is self-contained behind its own
    header). Malformed lines are skipped and counted, never fatal: a
    capture that survived a crash mid-write must still replay. A done
    record whose submit rotated away is an orphan (counted skipped);
    a submit with no done replays but cannot verify.

    A directory may span several ENGINE RUNS (a restarted server
    keeps appending to the same WALKAI_CAPTURE_DIR, continuing the
    file sequence): request ids restart at 0 per run, so runs must
    never be merged — a run-1 done pairing with a run-2 submit would
    produce false verdicts, and rid collisions would silently drop
    records. Runs are split on the header's `created_unix_s` (one
    `attach()` writes byte-identical headers into every file it
    rotates through; a restart stamps a new one). `run` selects
    which run to load (0-based, negative from the end); default the
    LATEST — the incident-relevant one. `Capture.runs` says how many
    were found so callers can surface the choice.

    A canary-armed fleet's capture carries each sampled request TWICE
    — the primary row serving the user plus a `mirrored: true` shadow
    row — so mirrored records are dropped by default (counted in
    `Capture.mirrored_skipped`); `include_mirrored=True` keeps them
    for shadow-side forensics."""
    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "capture-*.jsonl")))
    else:
        files = [path]
    if not files or not all(os.path.isfile(f) for f in files):
        raise FileNotFoundError(f"no capture files at {path!r}")
    # One bucket per engine run: {header, submits, dones, skipped}.
    run_keys: dict[tuple, int] = {}
    buckets: list[dict] = []
    stray_skipped = 0  # lines before any header / orphan records
    current: dict | None = None
    for fname in files:
        with open(fname) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                except ValueError:
                    # Attribute corruption to the run it sits in —
                    # a crash-corrupted line in run 1 must not read
                    # as run 0 having lost a record.
                    if current is not None:
                        current["skipped"] += 1
                    else:
                        stray_skipped += 1
                    continue
                if not isinstance(obj, dict):
                    if current is not None:
                        current["skipped"] += 1
                    else:
                        stray_skipped += 1
                    continue
                kind = obj.get("kind")
                if kind == "header":
                    fp = obj.get("fingerprint") or {}
                    key = (obj.get("created_unix_s"), fp.get("id"))
                    idx = run_keys.get(key)
                    if idx is None:
                        run_keys[key] = len(buckets)
                        buckets.append({
                            "header": fp, "submits": {},
                            "dones": {}, "skipped": 0,
                        })
                        idx = run_keys[key]
                    current = buckets[idx]
                elif current is None:
                    stray_skipped += 1
                elif kind == "submit" and "rid" in obj:
                    current["submits"][obj["rid"]] = obj
                elif kind == "done" and "rid" in obj:
                    current["dones"][obj["rid"]] = obj
                else:
                    current["skipped"] += 1
    if not buckets:
        raise ValueError(
            f"no capture header found at {path!r} (not a capture, or "
            f"every header line is corrupt)"
        )
    idx = len(buckets) - 1 if run is None else run
    try:
        bucket = buckets[idx]
    except IndexError:
        raise ValueError(
            f"capture at {path!r} holds {len(buckets)} run(s); "
            f"run={run} is out of range"
        ) from None
    idx = idx % len(buckets)  # normalize negative selectors
    submits, dones = bucket["submits"], bucket["dones"]
    # Orphan dones: their submit record was pruned by rotation.
    skipped = bucket["skipped"] + stray_skipped + sum(
        1 for rid in dones if rid not in submits
    )
    known = {f.name for f in CaptureRecord.__dataclass_fields__.values()}
    records = []
    mirrored_skipped = 0
    for rid in sorted(
        submits, key=lambda r: (submits[r].get("arrival_s", 0.0), r)
    ):
        merged = {**submits[rid], **(dones.get(rid) or {})}
        rec = CaptureRecord(**{
            k: v for k, v in merged.items() if k in known
        })
        if rec.mirrored and not include_mirrored:
            mirrored_skipped += 1
            continue
        records.append(rec)
    return Capture(
        bucket["header"], records, skipped, files,
        runs=len(buckets), run=idx,
        mirrored_skipped=mirrored_skipped,
    )


def build_config(fingerprint: dict, overrides: dict | None = None):
    """(LMConfig, engine_kwargs) from a fingerprint, with overrides
    applied — an override key is an engine knob when it names one,
    else an LMConfig field, else an error (a typo'd axis must not
    silently replay the unmodified config and report 'no
    divergence')."""
    from walkai_nos_tpu_torch.models.lm import LMConfig

    cfg_fields = dict(fingerprint.get("cfg") or {})
    eng = dict(fingerprint.get("engine") or {})
    if not cfg_fields or not eng:
        raise ValueError(
            "fingerprint has no cfg/engine sections (a fleet-level "
            "router capture? engine captures are the replayable "
            "artifact)"
        )
    valid_cfg = {f.name for f in dataclasses.fields(LMConfig)}
    for key, value in (overrides or {}).items():
        if key in ENGINE_KNOBS:
            eng[key] = value
        elif key in valid_cfg:
            cfg_fields[key] = value
        else:
            raise ValueError(
                f"unknown override {key!r}: not an engine knob "
                f"{ENGINE_KNOBS} or an LMConfig field"
            )
    cfg_fields = {
        k: v for k, v in cfg_fields.items() if k in valid_cfg
    }
    return LMConfig(**cfg_fields), eng


def _weights_for(params, cfg):
    """`params` as the engine built for `cfg` takes them. A `DecoderLM`
    built for another config (an override) is rebound: its tensors'
    values copied into a build for `cfg` when the weight format is the
    same, else a host copy of its weights for the engine to quantize."""
    from walkai_nos_tpu_torch.models.convert import flax_params_from_model
    from walkai_nos_tpu_torch.models.lm import DecoderLM

    if not isinstance(params, DecoderLM):
        return params
    own = {
        f: getattr(cfg, f) for f in (
            "ragged_decode", "paged_decode", "paged_blocks", "cache_len",
            "remat",
        )
    }
    if dataclasses.replace(params.cfg, **own) == cfg:
        return params
    if params.cfg.w_dtype == cfg.w_dtype:
        rebound = DecoderLM(cfg, device=params.device)
        rebound.load_state_dict(params.state_dict())
        return rebound
    return flax_params_from_model(params)


def build_engine(
    fingerprint: dict,
    params,
    *,
    overrides: dict | None = None,
    draft_cfg=None,
    draft_params=None,
    draft_seed: int = 0,
    obs=False,
    capture=None,
    adapters=None,
    device=None,
):
    """Rebuild a ContinuousBatcher from a capture fingerprint (plus
    overrides) on `device` (None: `cuda`). `params` is the caller's
    weights: captures store a digest, not weights; `cmd/replay.py`
    re-initializes from a seed and warns on a digest mismatch. A spec
    replay with no draft given builds an UNTRAINED draft
    (`draft_config` + `DecoderLM(seed=draft_seed)`): speculative serving
    is spec-off tokens for any draft weights in exact arithmetic, so an
    untrained draft is a replay axis, not an approximation.

    A LoRA-armed capture (the fingerprint has a `lora` block) replays
    with a rebuilt adapter set: a synthetic recipe rebuilds the exact
    set from its seed (`AdapterSet.synthetic`); real adapters need the
    caller's `adapters`, as base weights need `params`."""
    from walkai_nos_tpu_torch.models.serve import ContinuousBatcher

    cfg, eng = build_config(fingerprint, overrides)
    lora_fp = (fingerprint or {}).get("lora")
    if adapters is None and lora_fp:
        recipe = dict(lora_fp.get("recipe") or {})
        if recipe.pop("kind", None) != "synthetic":
            raise ValueError(
                "capture fingerprint records real LoRA adapters "
                f"(digests {lora_fp.get('digests')}); pass adapters= "
                "with the matching AdapterSet to replay it"
            )
        from walkai_nos_tpu_torch.models.lora import AdapterSet

        adapters = AdapterSet.synthetic(cfg, **recipe)
    kwargs = {
        k: eng[k] for k in ENGINE_KNOBS
        if k in eng and k not in ("spec",)
    }
    if not kwargs.get("paged", True):
        # Dense engines record pool_blocks=0 (and no lane); the
        # constructor derives its own values.
        for k in ("pool_blocks", "prefill_chunk", "prefill_lanes"):
            kwargs.pop(k, None)
    elif not kwargs.get("pool_blocks"):
        kwargs.pop("pool_blocks", None)
    if eng.get("spec"):
        from walkai_nos_tpu_torch.models.lm import DecoderLM, draft_config

        if draft_cfg is None:
            draft_cfg = draft_config(cfg)
        if draft_params is None:
            draft_params = DecoderLM(draft_cfg, device=device, seed=draft_seed)
        kwargs.update(
            spec=True, draft_cfg=draft_cfg, draft_params=draft_params,
        )
    if adapters is not None:
        kwargs["adapters"] = adapters
    return ContinuousBatcher(
        cfg, _weights_for(params, cfg), obs=obs, capture=capture,
        device=device, **kwargs,
    )


@dataclass
class ReplayOutcome:
    rid: int
    arrival_s: float
    tokens: list | None  # replayed output (None: submit rejected)
    expected: list | None  # captured output (None: never completed)
    match: bool | None = None  # None: unverifiable (never completed)
    first_divergent_token: int | None = None
    error: str | None = None  # replay-side submit rejection


@dataclass
class ReplayReport:
    fingerprint_id: str | None
    overrides: dict
    outcomes: dict[int, ReplayOutcome] = field(default_factory=dict)
    divergent: list[int] = field(default_factory=list)  # arrival order
    n_requests: int = 0
    n_verified: int = 0
    skipped_records: int = 0
    replay_wall_s: float = 0.0

    @property
    def ok(self) -> bool:
        return not self.divergent

    def summary(self) -> dict:
        return {
            "fingerprint": self.fingerprint_id,
            "overrides": self.overrides,
            "requests": self.n_requests,
            "verified": self.n_verified,
            "divergent": len(self.divergent),
            "first_divergent_rid": (
                self.divergent[0] if self.divergent else None
            ),
            "skipped_records": self.skipped_records,
            "replay_wall_s": round(self.replay_wall_s, 3),
            "ok": self.ok,
        }


def first_divergence(expected: list, got: list) -> int:
    """Index of the first divergent token between two streams (a
    stream that is a strict prefix of the other diverges at the
    shorter length). Shared by replay verification and the canary
    plane's per-request digest diff."""
    for i, (a, b) in enumerate(zip(expected, got)):
        if int(a) != int(b):
            return i
    return min(len(expected), len(got))


def _submit_record(engine, rec: CaptureRecord) -> int:
    return engine.submit(
        rec.prompt,
        max_new_tokens=rec.max_new_tokens,
        eos_id=rec.eos_id,
        temperature=rec.temperature,
        top_k=rec.top_k,
        top_p=rec.top_p,
        seed=rec.seed,
        adapter=rec.adapter,
    )


def replay_capture(
    capture: Capture,
    params=None,
    *,
    engine=None,
    overrides: dict | None = None,
    timing: str = "asap",
    speed: float = 1.0,
    draft_cfg=None,
    draft_params=None,
    draft_seed: int = 0,
    obs=False,
    adapters=None,
    device=None,
) -> ReplayReport:
    """Re-execute a capture and verify every completion. Pass either
    a prebuilt `engine` or the weight tree `params` (the engine is
    then rebuilt from the capture's fingerprint + `overrides`).
    Returns a ReplayReport; `report.ok` is the zero-divergence
    verdict `cmd/replay.py` (and `make replay-check`) exits on."""
    if timing not in ("asap", "original"):
        raise ValueError(
            f"timing must be 'asap' or 'original'; got {timing!r}"
        )
    if engine is None:
        if params is None:
            raise ValueError("replay_capture needs params or engine")
        engine = build_engine(
            capture.fingerprint, params, overrides=overrides,
            draft_cfg=draft_cfg, draft_params=draft_params,
            draft_seed=draft_seed, obs=obs, adapters=adapters,
            device=device,
        )
    report = ReplayReport(
        fingerprint_id=capture.fingerprint_id,
        overrides=dict(overrides or {}),
        n_requests=len(capture.records),
        skipped_records=capture.skipped,
    )
    t0 = time.monotonic()
    rid_map: dict[int, CaptureRecord] = {}
    rejected: list[tuple[CaptureRecord, str]] = []

    def submit(rec: CaptureRecord) -> None:
        try:
            rid_map[_submit_record(engine, rec)] = rec
        except ValueError as bad:
            # A replay-side rejection (e.g. an override shrank the
            # admissible space) is a divergence too — the original
            # engine served this request.
            rejected.append((rec, str(bad)))

    if timing == "asap":
        for rec in capture.records:
            submit(rec)
        results = engine.run()
    else:
        speed = max(speed, 1e-9)
        results = {}
        pending = list(capture.records)
        while pending or engine.has_work:
            now = time.monotonic() - t0
            while pending and pending[0].arrival_s / speed <= now:
                submit(pending.pop(0))
            if engine.has_work:
                engine.step()
                results.update(engine.drain_done())
            elif pending:
                time.sleep(
                    min(0.01, pending[0].arrival_s / speed - now)
                )
        results.update(engine.drain_done())

    for new_rid, rec in rid_map.items():
        got = results.get(new_rid)
        out = ReplayOutcome(
            rid=rec.rid, arrival_s=rec.arrival_s,
            tokens=list(got) if got is not None else None,
            expected=rec.tokens,
        )
        if rec.tokens is None or got is None:
            out.match = None  # unverifiable: capture never completed
        else:
            expected = list(map(int, rec.tokens))
            replayed = list(map(int, got))
            if rec.truncated:
                # A pool-truncated completion's length is a function
                # of LIVE pool pressure, not of the purity invariant
                # (which covers token VALUES): the replay may cut at
                # a different point or run to budget. Either stream
                # being a prefix of the other is a verified match —
                # only a value divergence inside the common prefix
                # is real.
                n = min(len(expected), len(replayed))
                out.match = expected[:n] == replayed[:n]
            else:
                out.match = expected == replayed
            report.n_verified += 1
            if not out.match:
                out.first_divergent_token = first_divergence(
                    expected, replayed
                )
        report.outcomes[rec.rid] = out
    for rec, err in rejected:
        report.outcomes[rec.rid] = ReplayOutcome(
            rid=rec.rid, arrival_s=rec.arrival_s, tokens=None,
            expected=rec.tokens, match=False, error=err,
            first_divergent_token=0 if rec.tokens else None,
        )
    report.divergent = [
        rec.rid for rec in capture.records
        if report.outcomes.get(rec.rid) is not None
        and report.outcomes[rec.rid].match is False
    ]
    report.replay_wall_s = time.monotonic() - t0
    return report


def triage_divergence(
    capture: Capture,
    report: ReplayReport,
    params,
    *,
    overrides: dict | None = None,
    draft_cfg=None,
    draft_params=None,
    draft_seed: int = 0,
    flight=None,
    flight_dir: str | None = None,
    adapters=None,
    device=None,
) -> dict | None:
    """First-divergence triage: isolate the earliest divergent
    request, re-run it SOLO on a fresh engine (same replay config) to
    classify batch-dependent vs config-dependent, and dump a
    flight-recorder-format bundle (both configs' fingerprints, the
    offending record, the divergence coordinates, the solo engine's
    debug_state). Returns the triage verdict (None when the replay
    was clean)."""
    if report.ok:
        return None
    rid = report.divergent[0]
    rec = next(r for r in capture.records if r.rid == rid)
    outcome = report.outcomes[rid]
    solo_engine = build_engine(
        capture.fingerprint, params, overrides=overrides,
        draft_cfg=draft_cfg, draft_params=draft_params,
        draft_seed=draft_seed, obs=False, adapters=adapters,
        device=device,
    )
    solo_tokens: list | None = None
    solo_error: str | None = None
    try:
        solo_rid = _submit_record(solo_engine, rec)
        solo_tokens = solo_engine.run().get(solo_rid)
    except ValueError as bad:
        solo_error = str(bad)
    captured = list(map(int, rec.tokens or []))
    if solo_tokens is None:
        solo_matches_capture = False
    elif rec.truncated:
        # Same prefix rule as verification: a truncation point is
        # pool pressure, not the serving function.
        n = min(len(captured), len(solo_tokens))
        solo_matches_capture = list(map(int, solo_tokens))[:n] == (
            captured[:n]
        )
    else:
        solo_matches_capture = (
            list(map(int, solo_tokens)) == captured
        )
    classification = (
        # The request ALONE still reproduces the capture: the
        # divergence appears only under batch composition — a
        # violated engine invariant, not a config question.
        "batch_dependent" if solo_matches_capture
        else "config_dependent"
    )
    verdict = {
        "rid": rid,
        "trace_id": rec.trace_id,
        "token_index": outcome.first_divergent_token,
        "expected_token": (
            captured[outcome.first_divergent_token]
            if outcome.first_divergent_token is not None
            and outcome.first_divergent_token < len(captured)
            else None
        ),
        "got_token": (
            outcome.tokens[outcome.first_divergent_token]
            if outcome.tokens is not None
            and outcome.first_divergent_token is not None
            and outcome.first_divergent_token < len(outcome.tokens)
            else None
        ),
        "classification": classification,
        "divergent_requests": len(report.divergent),
        "solo_error": solo_error or outcome.error,
    }
    if flight is None:
        from walkai_nos_tpu_torch.obs.anomaly import FlightRecorder

        # min_interval 0: consecutive triage runs must both land
        # (the anomaly recorder's throttle exists for flap storms,
        # not for an operator re-running a bisect).
        flight = FlightRecorder(flight_dir, min_interval_s=0.0)
    bundle = {
        "verdict": dict(verdict),
        "capture_fingerprint": capture.fingerprint,
        "replay_fingerprint": solo_engine.config_fingerprint(),
        "overrides": dict(overrides or {}),
        "record": {
            "rid": rec.rid, "prompt": rec.prompt,
            "max_new_tokens": rec.max_new_tokens,
            "eos_id": rec.eos_id, "temperature": rec.temperature,
            "top_k": rec.top_k, "top_p": rec.top_p, "seed": rec.seed,
            "adapter": rec.adapter,
            "arrival_s": rec.arrival_s, "trace_id": rec.trace_id,
            "captured_tokens": rec.tokens,
            "captured_digest": rec.digest,
        },
        "replayed_tokens": outcome.tokens,
        "solo_tokens": (
            list(map(int, solo_tokens))
            if solo_tokens is not None else None
        ),
        "debug_state": solo_engine.debug_state(),
    }
    verdict["bundle_path"] = flight.dump("replay_divergence", bundle)
    return verdict
