"""The metrics registry: counters, gauges and log-bucketed histograms.

Port of `walkai_nos_tpu/obs/metrics.py`, stdlib only: the one registry the
serving engine's bundle (`obs/serving.ServingObs`) writes and `render()`
exposes as Prometheus text (format 0.0.4), byte for byte as the JAX
package's registry renders the same writes.

- **Off the critical path.** Writes happen on the host, at the engine's
  sync points, between device dispatches that take milliseconds: a dict
  update under one lock. `Registry(enabled=False)` turns every write into
  one flag check (the `obs=False` arm of the overhead A/B).
- **Exposition.** Label values are escaped, so one hostile value cannot
  corrupt the payload; histograms export the full contract (cumulative
  `_bucket{le=...}` series, `+Inf`, `_sum`, `_count`). A metric with no
  series is omitted.

Histograms are log-bucketed (`log_buckets`): serving latencies span about
four decades, so geometric spacing gives a constant relative resolution
and every quantile is exact to within one bucket.
"""

from __future__ import annotations

import math
import threading

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "escape_label",
    "log_buckets",
]


def escape_label(value) -> str:
    """Prometheus exposition label escaping: one bad value (a quote or
    newline from an object name or error string) must not corrupt the
    whole /metrics payload."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def log_buckets(
    lo: float, hi: float, per_decade: int = 3
) -> tuple[float, ...]:
    """Geometric bucket upper bounds from `lo` until `hi` is covered:
    `per_decade` bounds per power of ten, so resolution is a constant
    RATIO (10^(1/per_decade), ~2.15x at the default) across the whole
    range — the right shape for latencies spanning decades."""
    if not (lo > 0 and hi > lo and per_decade > 0):
        raise ValueError(
            f"need 0 < lo < hi and per_decade > 0; "
            f"got {lo}, {hi}, {per_decade}"
        )
    bounds = []
    exp = math.log10(lo)
    step = 1.0 / per_decade
    while True:
        b = 10.0 ** exp
        # Snap to a clean decimal (10^k x {1, 2.15, 4.64} style values
        # print horribly); round to 4 significant digits instead.
        b = float(f"{b:.4g}")
        bounds.append(b)
        if b >= hi:
            return tuple(bounds)
        exp += step


# Serving latencies: 1 ms resolution floor, 100 s ceiling (the demo
# server's request timeout is 120 s; anything slower lands in +Inf).
DEFAULT_TIME_BUCKETS = log_buckets(1e-3, 100.0)


def _fmt(value: float) -> str:
    """Render a sample value: integral floats print as integers (the
    common case for counters), everything else as repr (full float
    precision; Prometheus parsers accept Go float syntax). Non-finite
    values use the format's own spellings — a gauge someone set to
    inf/NaN must not take down the whole exposition."""
    if not math.isfinite(value):
        if value != value:
            return "NaN"
        return "+Inf" if value > 0 else "-Inf"
    if value == int(value) and abs(value) < 2**53:
        return str(int(value))
    return repr(value)


class _Metric:
    """Base: a named instrument registered in one `Registry`. Series
    (per-label-set values) live here, guarded by the registry lock."""

    kind = "untyped"

    def __init__(self, registry: "Registry", name: str, help_text: str):
        self._registry = registry
        self._lock = registry._lock
        self._enabled = registry.enabled
        self.name = name
        self.help = help_text
        self._series: dict[tuple, object] = {}

    @staticmethod
    def _key(labels: dict | None) -> tuple:
        return tuple(sorted((labels or {}).items()))

    def labelsets(self) -> list[dict]:
        with self._lock:
            return [dict(k) for k in self._series]

    def remove(self, labels: dict | None = None) -> None:
        """Drop one label set's series entirely, so exposition stops
        exporting it. For series whose label values name transient
        members (a fleet replica that was retired): keeping the last
        value exports a dead member as live forever, and 0 would read
        as 'observed idle', not 'gone'."""
        with self._lock:
            self._series.pop(self._key(labels), None)


class Counter(_Metric):
    """Monotonically increasing sum. Name should end in `_total` (or
    `_sum` for cumulative seconds), per Prometheus convention."""

    kind = "counter"

    def inc(self, value: float = 1.0, labels: dict | None = None) -> None:
        if not self._enabled:
            return
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def value(self, labels: dict | None = None) -> float:
        with self._lock:
            return float(self._series.get(self._key(labels), 0.0))


class Gauge(_Metric):
    """A value that goes up and down. `value()` is None until the
    first `set` — "never observed" and "observed 0" are different
    answers for snapshot-style consumers (`kv_stats`)."""

    kind = "gauge"

    def set(self, value: float, labels: dict | None = None) -> None:
        if not self._enabled:
            return
        with self._lock:
            self._series[self._key(labels)] = float(value)

    def set_min(self, value: float, labels: dict | None = None) -> None:
        """Keep the smallest value ever set — a low watermark (the
        block pool's worst-case headroom under load)."""
        if not self._enabled:
            return
        key = self._key(labels)
        with self._lock:
            prev = self._series.get(key)
            if prev is None or value < prev:
                self._series[key] = float(value)

    def value(self, labels: dict | None = None) -> float | None:
        with self._lock:
            v = self._series.get(self._key(labels))
            return None if v is None else float(v)


class _HistState:
    __slots__ = ("counts", "total", "sum")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets  # per-bucket (non-cumulative)
        self.total = 0  # includes the +Inf overflow
        self.sum = 0.0


class Histogram(_Metric):
    """Log-bucketed histogram. A sample lands in the first bucket
    whose upper bound is >= the value (Prometheus `le` semantics:
    bounds are INCLUSIVE upper edges); values above the last bound
    count only toward `+Inf`/`_count`/`_sum`."""

    kind = "histogram"

    def __init__(
        self,
        registry: "Registry",
        name: str,
        help_text: str,
        buckets: tuple[float, ...] | None = None,
    ):
        super().__init__(registry, name, help_text)
        bounds = tuple(buckets or DEFAULT_TIME_BUCKETS)
        if list(bounds) != sorted(set(bounds)):
            raise ValueError(
                f"histogram {name} buckets must be strictly increasing"
            )
        self.bounds = bounds

    def observe(self, value: float, labels: dict | None = None) -> None:
        if not self._enabled:
            return
        key = self._key(labels)
        with self._lock:
            state = self._series.get(key)
            if state is None:
                state = self._series[key] = _HistState(len(self.bounds))
            # Linear scan: bucket counts are small (~20) and the scan
            # usually exits in the first few bounds for sub-second
            # latencies; bisect would allocate a key tuple per call.
            for i, b in enumerate(self.bounds):
                if value <= b:
                    state.counts[i] += 1
                    break
            state.total += 1
            state.sum += value

    def count(self, labels: dict | None = None) -> int:
        with self._lock:
            state = self._series.get(self._key(labels))
            return 0 if state is None else state.total

    def snapshot_counts(
        self, labels: dict | None = None
    ) -> tuple[list[int], int]:
        """(per-bucket counts copy, total incl. the +Inf overflow) —
        the raw material the sliding-window SLO layer (`obs/slo.py`)
        snapshots into its ring of buckets: two snapshots differenced
        give the bucket counts of exactly the samples between them."""
        with self._lock:
            state = self._series.get(self._key(labels))
            if state is None:
                return [0] * len(self.bounds), 0
            return list(state.counts), state.total

    def sum(self, labels: dict | None = None) -> float:
        with self._lock:
            state = self._series.get(self._key(labels))
            return 0.0 if state is None else state.sum

    def quantile(self, q: float, labels: dict | None = None) -> float | None:
        """Upper bound of the bucket containing the q-quantile (q in
        [0, 1]) — exact to within one bucket width, which is the
        guarantee the bench parity test leans on. Samples in the +Inf
        overflow report the last finite bound (Prometheus
        `histogram_quantile` clamps the same way). None until any
        sample lands."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1]; got {q}")
        with self._lock:
            state = self._series.get(self._key(labels))
            if state is None or state.total == 0:
                return None
            # Nearest-rank on the cumulative counts.
            rank = max(1, math.ceil(q * state.total))
            cum = 0
            for i, c in enumerate(state.counts):
                cum += c
                if cum >= rank:
                    return self.bounds[i]
            return self.bounds[-1]


class Registry:
    """Named instruments + Prometheus text exposition.

    `counter/gauge/histogram` are get-or-create: the first call fixes
    the kind and help text (re-registration with a different kind is a
    programming error and raises). `enabled=False` builds a registry
    whose instruments no-op on write — the disabled arm of the
    `obs_overhead_pct` A/B."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help_text: str, **kw):
        # Create under the lock: two threads racing the same name must
        # never each see "absent" and hand one of them an instrument
        # of the other's kind (instrument __init__ only assigns
        # attributes — no lock re-entry, no I/O).
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = cls(self, name, help_text, **kw)
                self._metrics[name] = metric
        if not isinstance(metric, cls):
            raise ValueError(
                f"metric {name} already registered as "
                f"{metric.kind}, not {cls.kind}"
            )
        return metric

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._get_or_create(Counter, name, help_text)

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help_text)

    def histogram(
        self,
        name: str,
        help_text: str = "",
        buckets: tuple[float, ...] | None = None,
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help_text, buckets=buckets
        )

    def get(self, name: str) -> _Metric | None:
        with self._lock:
            return self._metrics.get(name)

    def describe(self) -> dict[str, tuple[str, str]]:
        """name -> (kind, help) for every registered instrument."""
        with self._lock:
            return {
                name: (m.kind, m.help)
                for name, m in sorted(self._metrics.items())
            }

    def render(self) -> str:
        """Prometheus text exposition (format 0.0.4)."""
        lines: list[str] = []
        with self._lock:
            metrics = sorted(self._metrics.items())
        for name, metric in metrics:
            with self._lock:
                series = sorted(
                    self._series_snapshot(metric).items()
                )
            if not series:
                continue
            if metric.help:
                lines.append(f"# HELP {name} {metric.help}")
            lines.append(f"# TYPE {name} {metric.kind}")
            for key, value in series:
                if isinstance(metric, Histogram):
                    self._render_histogram(
                        lines, name, metric, key, value
                    )
                else:
                    lines.append(
                        f"{name}{self._labels(key)} {_fmt(value)}"
                    )
        return "\n".join(lines) + "\n"

    @staticmethod
    def _series_snapshot(metric: _Metric) -> dict:
        # Caller holds the lock; histograms copy their mutable state.
        if isinstance(metric, Histogram):
            out = {}
            for key, st in metric._series.items():
                copy = _HistState(len(st.counts))
                copy.counts = list(st.counts)
                copy.total, copy.sum = st.total, st.sum
                out[key] = copy
            return out
        return dict(metric._series)

    @staticmethod
    def _labels(key: tuple, extra: str = "") -> str:
        parts = [f'{k}="{escape_label(v)}"' for k, v in key]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    @classmethod
    def _render_histogram(
        cls, lines: list, name: str, metric: Histogram, key: tuple,
        state: _HistState,
    ) -> None:
        cum = 0
        for bound, count in zip(metric.bounds, state.counts):
            cum += count
            le = 'le="' + _fmt(bound) + '"'
            lines.append(f"{name}_bucket{cls._labels(key, le)} {cum}")
        inf = 'le="+Inf"'
        lines.append(
            f"{name}_bucket{cls._labels(key, inf)} {state.total}"
        )
        lines.append(f"{name}_sum{cls._labels(key)} {_fmt(state.sum)}")
        lines.append(f"{name}_count{cls._labels(key)} {state.total}")
