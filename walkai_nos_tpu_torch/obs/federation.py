"""Fleet federation: per-replica metrics and traces merged into one.

Port of `walkai_nos_tpu/obs/federation.py`:

- `parse_exposition` reads Prometheus 0.0.4 text (the inverse of
  `Registry.render`) into metric families; `first_value` reads one
  unlabelled series;
- `federate` re-exports every replica's engine series (the `cb_`
  prefix) under a `replica` label, families and replicas in name order,
  so the router's `federated_metrics()` is one deterministic text;
- `merge_fleet_trace` merges the router's Chrome trace with each
  replica's into one clock-aligned timeline: each source's events are
  re-based into the router's clock (`clock_origin + ts - offset_s`,
  0 for an in-process replica), given a pid of its own and sorted.

Stdlib only.
"""

from __future__ import annotations

import re

from walkai_nos_tpu_torch.obs.metrics import _fmt, escape_label

__all__ = [
    "FEDERATED_PREFIXES",
    "federate",
    "first_value",
    "merge_fleet_trace",
    "parse_exposition",
]

# Engine series re-exported under a `replica` label. A `replica` label
# belongs to the router's series only: engines never label themselves.
FEDERATED_PREFIXES: tuple[str, ...] = ("cb_",)

_SAMPLE = re.compile(
    r"^([A-Za-z_:][A-Za-z0-9_:]*)"      # sample name
    r"(?:\{(.*)\})?"                     # optional label block
    # Value: the '-' inside the class covers negative EXPONENTS too
    # (repr of |v| < 1e-4 renders as e.g. 5e-05 — a fast replica's
    # sub-100µs dispatch p99 must not silently vanish from the
    # federation).
    r" (-?[0-9.eE+-]+|NaN|[+-]Inf)$"
)
_LABEL = re.compile(r'([A-Za-z_][A-Za-z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape(value: str) -> str:
    return (
        value.replace("\\n", "\n")
        .replace('\\"', '"')
        .replace("\\\\", "\\")
    )


def parse_exposition(text: str) -> dict[str, dict]:
    """Prometheus 0.0.4 text -> {family name: {"kind", "help",
    "samples": [(sample name, labels dict, value)]}}.

    The `_parse_value`-style inverse of `Registry.render` (and the
    demo server's /metrics): `# TYPE`/`# HELP` comments open a metric
    family; following sample lines attach to it (histogram `_bucket`/
    `_sum`/`_count` suffixes included, since their names extend the
    family's). A sample with no preceding family opens an implicit
    untyped one. Families render contiguously in this repo's
    exposition, which is the only format the federator consumes."""
    families: dict[str, dict] = {}
    current: str | None = None

    def family(name: str, kind: str = "untyped") -> dict:
        return families.setdefault(
            name, {"kind": kind, "help": "", "samples": []}
        )

    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            parts = line.split(" ", 3)
            if len(parts) >= 3:
                current = parts[2]
                family(current)["help"] = (
                    parts[3] if len(parts) > 3 else ""
                )
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ", 3)
            if len(parts) >= 4:
                current = parts[2]
                family(current)["kind"] = parts[3]
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        if m is None:
            continue
        name, label_blob, raw = m.groups()
        labels = {
            k: _unescape(v)
            for k, v in _LABEL.findall(label_blob or "")
        }
        try:
            value = float(raw.replace("Inf", "inf"))
        except ValueError:
            continue
        if current is not None and (
            name == current or name.startswith(current + "_")
        ):
            families[current]["samples"].append((name, labels, value))
        else:
            current = name
            family(name)["samples"].append((name, labels, value))
    return families


def first_value(text: str, name: str) -> float | None:
    """First sample value of an UNLABELED series `name` in a text
    exposition; None when absent (bench_lm's `_parse_value` shape —
    the parse the HttpReplica signal reads use)."""
    m = re.search(
        rf"^{re.escape(name)} (-?[0-9.eE+-]+|NaN|[+-]Inf)$",
        text, re.MULTILINE,
    )
    if m is None:
        return None
    try:
        return float(m.group(1).replace("Inf", "inf"))
    except ValueError:
        return None


def _render_labels(labels: dict) -> str:
    if not labels:
        return ""
    parts = [
        f'{k}="{escape_label(v)}"' for k, v in sorted(labels.items())
    ]
    return "{" + ",".join(parts) + "}"


def federate(
    sources: dict[str, str],
    *,
    prefixes: tuple[str, ...] = FEDERATED_PREFIXES,
    label: str = "replica",
) -> str:
    """Merge per-replica expositions into one, each series tagged
    `{replica="<name>"}`. Only families whose name starts with a
    federated prefix ride through (router_* and anything else a
    source might carry stays the source's own); HELP/TYPE render once
    per family (first source's wins), sources render in name order so
    the output is deterministic. Empty when no source carries a
    federated family."""
    merged: dict[str, dict] = {}
    for replica in sorted(sources):
        for name, fam in parse_exposition(sources[replica]).items():
            if not any(name.startswith(p) for p in prefixes):
                continue
            slot = merged.setdefault(
                name,
                {"kind": fam["kind"], "help": fam["help"], "rows": []},
            )
            for sample_name, labels, value in fam["samples"]:
                labels = {
                    k: v for k, v in labels.items() if k != label
                }
                labels[label] = replica
                slot["rows"].append((sample_name, labels, value))
    lines: list[str] = []
    for name in sorted(merged):
        fam = merged[name]
        if fam["help"]:
            lines.append(f"# HELP {name} {fam['help']}")
        lines.append(f"# TYPE {name} {fam['kind']}")
        for sample_name, labels, value in fam["rows"]:
            lines.append(
                f"{sample_name}{_render_labels(labels)} {_fmt(value)}"
            )
    return "\n".join(lines) + "\n" if lines else ""


def merge_fleet_trace(
    router_trace: dict, replicas: list[dict]
) -> dict:
    """One clock-aligned Chrome trace from the router's own export
    plus each replica's (`[{"name", "trace", "offset_s"}]`, where
    `offset_s` is the replica clock MINUS the router clock — an
    in-process replica's is 0.0 by construction).

    Every source's events are re-based into the router clock frame
    (`t_router = clock_origin + ts/1e6 - offset_s`), given a distinct
    Chrome pid, and sorted — scrubbing the merged file in Perfetto
    shows one request's router route/queue spans and its engine's
    prefill/decode spans in true order under one trace id. Exact
    per-span metadata (the engine decode event's `ttft_s`, the
    record-equal floats) rides through untouched in event args, so
    the merge never degrades span-derived latencies to microsecond
    rounding. Sources with no clock origin (empty traces) are
    skipped and listed in `otherData.skipped`."""
    sources: list[tuple[str, int, dict | None, float]] = [
        ("router", 1, router_trace, 0.0)
    ]
    pid = 10
    for rep in replicas:
        sources.append((
            f"replica {rep['name']}", pid, rep.get("trace"),
            float(rep.get("offset_s") or 0.0),
        ))
        pid += 1
    staged: list[tuple[float, dict]] = []
    metas: list[dict] = []
    skipped: list[str] = []
    processes: dict[int, str] = {}
    for name, pid, trace, offset in sources:
        if not isinstance(trace, dict):
            if trace is not None:
                skipped.append(name)
            continue
        events = trace.get("traceEvents") or []
        origin = (trace.get("otherData") or {}).get(
            "clock_origin_monotonic_s"
        )
        if origin is None:
            if events:
                skipped.append(name)
            continue
        processes[pid] = name
        base = float(origin) - offset  # router-clock second of ts=0
        for event in events:
            event = dict(event)
            event["pid"] = pid
            if event.get("ph") == "M":
                if event.get("name") == "process_name":
                    continue  # replaced by the merged process metas
                metas.append(event)
                continue
            staged.append(
                (base + float(event.get("ts", 0)) / 1e6, event)
            )
    if staged:
        t0 = min(t for t, _ in staged)
    else:
        t0 = 0.0
    out: list[dict] = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": pid,
            "args": {"name": name},
        }
        for pid, name in sorted(processes.items())
    ]
    out.extend(metas)
    rebased = []
    for abs_t, event in staged:
        event["ts"] = max(0, int(round((abs_t - t0) * 1e6)))
        rebased.append(event)
    rebased.sort(key=lambda e: e["ts"])
    out.extend(rebased)
    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "otherData": {
            "clock_origin_monotonic_s": t0 if staged else None,
            "processes": {
                str(pid): name
                for pid, name in sorted(processes.items())
            },
            "skipped": skipped,
        },
    }
