"""Label-aware metrics registry.

A copy of ``kubeadmiral_tpu/runtime/metrics.py`` (pure Python): the
``{Store, Counter, Rate, Timer, Duration}`` surface of the reference's
pkg/stats/stats.go over an in-memory time-series registry:

* every emission may carry ``**tags`` — ``counter("worker_retries",
  cluster="c1")`` and ``cluster="c2"`` are distinct series, keyed by the
  name plus the *sorted* label pairs (untagged call sites keep their
  plain-name keys, so readers of ``metrics.counters[...]`` /
  ``.stores[...]`` / ``.durations[...]`` see plain names);
* ``duration()`` additionally feeds a fixed-bucket histogram of the same
  name, and ``histogram()`` observes one directly;
* :meth:`render_prometheus` serializes the whole registry in Prometheus
  text exposition format (name sanitization, label escaping, cumulative
  histogram buckets, deterministic ordering).

The port's engine reports its per-tick telemetry here
(``SchedulerEngine(metrics=)``); the series names are the JAX engine's.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Optional, Sequence

# Prometheus' default latency buckets (seconds) — control-plane
# reconciles and device ticks both land comfortably inside them.
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0,
)

# Keep the raw per-series duration lists bounded: they exist for
# test/monitor readback, not long-horizon storage (the histogram is the
# durable aggregate).
_MAX_RAW_DURATIONS = 4096

LabelPairs = tuple[tuple[str, str], ...]


def series_key(name: str, tags: dict) -> str:
    """The string key a (name, labels) series lives under in the legacy
    dict views: the bare name when untagged, else the name plus sorted
    ``{k=v,...}`` pairs — so differently-labeled emissions never collide
    and untagged call sites keep their historical keys."""
    if not tags:
        return name
    pairs = ",".join(f"{k}={tags[k]}" for k in sorted(tags))
    return f"{name}{{{pairs}}}"


def _label_pairs(tags: dict) -> LabelPairs:
    return tuple((k, str(tags[k])) for k in sorted(tags))


class Histogram:
    """Fixed-bucket histogram; bucket counts are per-bucket (cumulation
    happens at exposition, as Prometheus expects)."""

    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        for i, bound in enumerate(self.buckets):
            if value <= bound:
                self.counts[i] += 1
                break
        else:
            self.counts[-1] += 1
        self.sum += value
        self.count += 1

    def cumulative(self) -> list[tuple[float, int]]:
        """[(le, cumulative count), ...] ending with (inf, total)."""
        out = []
        running = 0
        for bound, n in zip(self.buckets, self.counts):
            running += n
            out.append((bound, running))
        out.append((float("inf"), self.count))
        return out

    def quantile(self, q: float) -> Optional[float]:
        """Interpolated quantile from the fixed buckets — the same
        linear-within-bucket estimate Prometheus' histogram_quantile()
        computes, so in-process percentiles (the SLO evaluator,
        /debug/slo, bench detail) agree with dashboard math.  Returns
        None on an empty histogram; a quantile landing in the +Inf
        bucket clamps to the highest finite bound (the estimate is a
        floor there, exactly as in PromQL)."""
        if self.count == 0:
            return None
        q = min(1.0, max(0.0, float(q)))
        target = q * self.count
        running = 0
        lower = 0.0
        for bound, n in zip(self.buckets, self.counts):
            if n > 0 and running + n >= target:
                return lower + (bound - lower) * ((target - running) / n)
            running += n
            lower = bound
        return self.buckets[-1] if self.buckets else None


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        # Legacy views, keyed by series_key(): untagged series keep their
        # plain-name keys so existing readers keep working.
        self.counters: dict[str, float] = {}
        self.stores: dict[str, float] = {}
        self.durations: dict[str, list[float]] = {}
        self.histograms: dict[str, Histogram] = {}
        # series key -> (family name, sorted label pairs), for exposition.
        self._series: dict[str, tuple[str, LabelPairs]] = {}
        # family name -> prometheus type ("counter"|"gauge"|"histogram");
        # first emission wins.
        self._types: dict[str, str] = {}

    def _register(self, name: str, tags: dict, mtype: str) -> str:
        key = series_key(name, tags)
        if key not in self._series:
            self._series[key] = (name, _label_pairs(tags))
            self._types.setdefault(name, mtype)
        return key

    # -- emission (the stats.go surface + histogram/gauge) ---------------
    def counter(self, name: str, value: float = 1, **tags) -> None:
        with self._lock:
            key = self._register(name, tags, "counter")
            self.counters[key] = self.counters.get(key, 0.0) + value

    def rate(self, name: str, value: float = 1, **tags) -> None:
        self.counter(name, value, **tags)

    def store(self, name: str, value: float, **tags) -> None:
        with self._lock:
            key = self._register(name, tags, "gauge")
            self.stores[key] = value

    gauge = store

    def duration(self, name: str, seconds: float, **tags) -> None:
        with self._lock:
            key = self._register(name, tags, "histogram")
            raw = self.durations.setdefault(key, [])
            raw.append(seconds)
            if len(raw) > _MAX_RAW_DURATIONS:
                del raw[: len(raw) - _MAX_RAW_DURATIONS]
            hist = self.histograms.get(key)
            if hist is None:
                hist = self.histograms[key] = Histogram()
            hist.observe(seconds)

    def histogram(
        self,
        name: str,
        value: float,
        buckets: Sequence[float] = DEFAULT_BUCKETS,
        **tags,
    ) -> None:
        with self._lock:
            key = self._register(name, tags, "histogram")
            hist = self.histograms.get(key)
            if hist is None:
                hist = self.histograms[key] = Histogram(buckets)
            hist.observe(value)

    @contextmanager
    def timer(self, name: str, **tags):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.duration(name, time.perf_counter() - start, **tags)

    # -- readback ---------------------------------------------------------
    def get_counter(self, name: str, **tags) -> float:
        with self._lock:
            return self.counters.get(series_key(name, tags), 0.0)

    def counter_family(self, name: str) -> dict[LabelPairs, float]:
        """Every series of one counter family, keyed by label pairs —
        what the monitor controller aggregates error rates from."""
        with self._lock:
            return {
                labels: self.counters[key]
                for key, (fam, labels) in self._series.items()
                if fam == name and key in self.counters
            }

    def sum_counter(self, name: str) -> float:
        return sum(self.counter_family(name).values())

    def histogram_quantiles(
        self, name: str, qs: Sequence[float] = (0.5, 0.99), **tags
    ) -> dict[float, Optional[float]]:
        """Interpolated quantile snapshot of one histogram series —
        the shared percentile extraction the SLO evaluator, /debug/slo
        and bench detail all read instead of re-implementing bucket
        math.  Missing series yield all-None values."""
        with self._lock:
            hist = self.histograms.get(series_key(name, tags))
        if hist is None:
            return {q: None for q in qs}
        return {q: hist.quantile(q) for q in qs}

    def histogram_count(self, name: str, **tags) -> int:
        with self._lock:
            hist = self.histograms.get(series_key(name, tags))
        return 0 if hist is None else hist.count

    def snapshot(self) -> dict:
        """JSON-friendly dump sharing the exposition vocabulary — what
        bench.py embeds in its BENCH artifact so the perf trajectory and
        live metrics speak one language."""
        with self._lock:
            out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
            for key, value in self.counters.items():
                out["counters"][key] = value
            for key, value in self.stores.items():
                out["gauges"][key] = value
            for key, hist in self.histograms.items():
                out["histograms"][key] = {
                    "sum": hist.sum,
                    "count": hist.count,
                    "buckets": {
                        ("+Inf" if le == float("inf") else repr(le)): n
                        for le, n in hist.cumulative()
                    },
                }
            return out

    # -- Prometheus text exposition ---------------------------------------
    def render_prometheus(self) -> str:
        with self._lock:
            families: dict[str, list[tuple[LabelPairs, str, object]]] = {}
            for key, (name, labels) in self._series.items():
                if key in self.counters:
                    families.setdefault(name, []).append(
                        (labels, "counter", self.counters[key])
                    )
                if key in self.stores:
                    families.setdefault(name, []).append(
                        (labels, "gauge", self.stores[key])
                    )
                if key in self.histograms:
                    families.setdefault(name, []).append(
                        (labels, "histogram", self.histograms[key])
                    )
            types = dict(self._types)
        lines: list[str] = []
        for name in sorted(families):
            prom = _sanitize_name(name)
            lines.append(f"# TYPE {prom} {types.get(name, 'untyped')}")
            for labels, kind, value in sorted(
                families[name], key=lambda item: item[0]
            ):
                if kind == "histogram":
                    for le, n in value.cumulative():
                        le_s = "+Inf" if le == float("inf") else _fmt_value(le)
                        lines.append(
                            f"{prom}_bucket{_fmt_labels(labels + (('le', le_s),))}"
                            f" {n}"
                        )
                    lines.append(
                        f"{prom}_sum{_fmt_labels(labels)} {_fmt_value(value.sum)}"
                    )
                    lines.append(f"{prom}_count{_fmt_labels(labels)} {value.count}")
                else:
                    lines.append(
                        f"{prom}{_fmt_labels(labels)} {_fmt_value(value)}"
                    )
        return "\n".join(lines) + "\n"


def _sanitize_name(name: str) -> str:
    """Metric names must match [a-zA-Z_:][a-zA-Z0-9_:]* — legacy dotted
    names (``monitor.clusters.ready``) map deterministically onto it."""
    out = [
        ch if (ch.isascii() and (ch.isalnum() or ch in "_:")) else "_"
        for ch in name
    ]
    if out and out[0].isdigit():
        out.insert(0, "_")
    return "".join(out) or "_"


def _escape_label_value(value: str) -> str:
    return value.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def _fmt_labels(labels: LabelPairs) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{_sanitize_name(k)}="{_escape_label_value(v)}"' for k, v in labels
    )
    return "{" + inner + "}"


def _fmt_value(value) -> str:
    f = float(value)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def null_metrics() -> Metrics:
    return Metrics()
