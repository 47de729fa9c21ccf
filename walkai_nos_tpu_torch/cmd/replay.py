"""replay: re-execute a capture log offline and verify every digest.

The port of `walkai_nos_tpu/cmd/replay.py`, with the same arguments and
exit codes, plus `--device`. The one-command incident workflow over the
capture plane (`obs/capture.py` -> `sim/replay.py`): load a capture
recorded by a `ContinuousBatcher(capture=...)`, rebuild the engine from
the capture's config fingerprint, re-submit the recorded traffic, and
verify every completion token stream. Exit 0 means a token-identical
replay (zero divergent requests); any divergence exits 1 AFTER
first-divergence triage: the earliest divergent request is re-run solo
to classify batch-dependent vs config-dependent, the first divergent
(request, token) is reported, and a flight bundle is dumped.

Usage:

    python -m walkai_nos_tpu_torch.cmd.replay CAPTURE [options]

    CAPTURE                 capture-*.jsonl file, or the directory
                            holding a rotated set
    --run N                 which engine run to replay when the
                            directory spans server restarts (request
                            ids restart per run; default the latest)
    --override KEY=VALUE    replay under a changed knob (repeatable):
                            engine knobs (loop_steps=1, spec=true,
                            prefix_cache=false, slots=8, ...) or
                            LMConfig fields (kv_dtype=int8-sim, ...)
    --timing asap|original  as-fast-as-possible (default) or re-paced
                            to the recorded arrival offsets
    --speed X               original-timing speedup factor
    --init-seed N           rebuild the weights as
                            DecoderLM(cfg, seed=N) on --device
                            (default 0); a digest mismatch against the
                            capture's fingerprint is noted up front
    --draft-init-seed N     spec-replay draft init (any draft weights
                            replay token-identically in exact
                            arithmetic; this only matters for
                            reproducing acceptance rates)
    --flight-dir DIR        where the divergence bundle lands
    --device DEV            cuda (default) or cpu
    --json                  machine-readable summary on stdout

Weights come from an init seed because captures store a DIGEST, not the
weights: the recorded `weights_crc32` is checked against the rebuilt
model, so "you replayed under different weights" is said before the
divergence report blames a config axis. The port's seeded weights are
not the JAX package's (nor the same seed's on another device), so a
capture written by the JAX engine, or on another device, gets that note
here; replay it through `sim/replay.py` with the weights it served.
"""

from __future__ import annotations

import argparse
import json
import sys

__all__ = ["main", "parse_args", "parse_override"]


def parse_override(text: str) -> tuple[str, object]:
    """KEY=VALUE -> (key, coerced value): bools ('true'/'false'),
    ints, floats, then the raw string (dtype names like 'int8-sim'
    stay strings)."""
    if "=" not in text:
        raise argparse.ArgumentTypeError(
            f"override must be KEY=VALUE; got {text!r}"
        )
    key, raw = text.split("=", 1)
    low = raw.strip().lower()
    if low in ("true", "false"):
        return key.strip(), low == "true"
    for cast in (int, float):
        try:
            return key.strip(), cast(raw)
        except ValueError:
            pass
    return key.strip(), raw


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description=(
            "re-execute a serving capture offline and verify every "
            "completion digest (sim/replay.py)"
        )
    )
    parser.add_argument(
        "capture",
        help="capture-*.jsonl file or the directory holding one",
    )
    parser.add_argument(
        "--override", action="append", default=[],
        type=parse_override, metavar="KEY=VALUE",
        help="replay under a changed engine knob or LMConfig field "
             "(repeatable)",
    )
    parser.add_argument(
        "--run", type=int, default=None,
        help="which engine run to replay when the capture dir spans "
             "server restarts (0-based, negative from the end; "
             "default: the latest run)",
    )
    parser.add_argument(
        "--timing", choices=("asap", "original"), default="asap",
    )
    parser.add_argument("--speed", type=float, default=1.0)
    parser.add_argument("--init-seed", type=int, default=0)
    parser.add_argument("--draft-init-seed", type=int, default=0)
    parser.add_argument("--flight-dir", default=None)
    parser.add_argument(
        "--device", default="cuda",
        help="where the replay engine runs (cuda, or cpu)",
    )
    parser.add_argument("--json", action="store_true")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from walkai_nos_tpu_torch.sim.replay import (
        ENGINE_KNOBS,
        build_config,
        load_capture,
        replay_capture,
        triage_divergence,
    )

    capture = load_capture(args.capture, run=args.run)
    overrides = dict(args.override)
    cfg, _ = build_config(capture.fingerprint, overrides)

    from walkai_nos_tpu_torch.models.convert import served_tree
    from walkai_nos_tpu_torch.models.lm import DecoderLM
    from walkai_nos_tpu_torch.obs.capture import tree_crc32

    params = DecoderLM(cfg, device=args.device, seed=args.init_seed)
    notes = []
    if capture.runs > 1:
        notes.append(
            f"capture spans {capture.runs} engine runs (request ids "
            f"restart per run); replaying run {capture.run} — select "
            f"another with --run"
        )
    recorded_crc = capture.fingerprint.get("weights_crc32")
    # The seeded model is the tree the engine serves, in any weight
    # format. An LMConfig-field override may change that tree, so it
    # suppresses the comparison; an engine knob (loop_steps,
    # prefix_cache, ...) cannot touch the weights, so it must not.
    cfg_overridden = any(k not in ENGINE_KNOBS for k in overrides)
    if (
        recorded_crc is not None
        and not cfg_overridden
        and tree_crc32(served_tree(params)) != recorded_crc
    ):
        notes.append(
            f"weights digest mismatch: rebuilt model (init seed "
            f"{args.init_seed}) != capture's weights_crc32 "
            f"{recorded_crc} — divergence, if any, is "
            f"config_dependent by construction"
        )
    report = replay_capture(
        capture, params,
        overrides=overrides,
        timing=args.timing,
        speed=args.speed,
        draft_seed=args.draft_init_seed,
        device=args.device,
    )
    verdict = None
    if not report.ok:
        verdict = triage_divergence(
            capture, report, params,
            overrides=overrides,
            draft_seed=args.draft_init_seed,
            flight_dir=args.flight_dir,
            device=args.device,
        )
    summary = {
        **report.summary(),
        "capture_files": capture.files,
        "notes": notes,
        "triage": verdict,
    }
    if args.json:
        print(json.dumps(summary, default=str))
    else:
        for note in notes:
            print(f"note: {note}")
        print(
            f"replayed {summary['requests']} request(s) "
            f"({summary['verified']} verified) from fingerprint "
            f"{summary['fingerprint']}: "
            + ("token-identical" if report.ok else
               f"{summary['divergent']} DIVERGENT")
        )
        if verdict is not None:
            print(
                f"first divergence: request {verdict['rid']} token "
                f"{verdict['token_index']} "
                f"(expected {verdict['expected_token']}, got "
                f"{verdict['got_token']}) — "
                f"{verdict['classification']}; bundle: "
                f"{verdict['bundle_path']}"
            )
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
