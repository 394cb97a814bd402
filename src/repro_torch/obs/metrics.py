"""Dependency-free in-process metrics: Counters, Gauges, and log-bucketed
Histograms with labeled series, mergeable snapshots, and Prometheus text
exposition — the port's copy of the reference's ``obs/metrics.py``, with
the same names and the same text exposition byte for byte, so one scraper
reads either server.

Pure stdlib on purpose: the scheduler (serving/scheduler.py) is host-only
with no torch import, so this module must not pull in numpy, torch, or any
client library. Everything is plain dicts and floats.

Model
-----
A ``Registry`` owns named metrics; each metric owns labeled *series*
(one per distinct label set, keyed by the canonical Prometheus label
string ``k1="v1",k2="v2"``). Three kinds:

* ``Counter`` — monotonically non-decreasing sum (``inc``).
* ``Gauge`` — last-written value (``set``).
* ``Histogram`` — geometric (log-spaced) buckets: bucket *i* counts
  observations ``<= lo * factor**i``, plus a +Inf overflow bucket, plus
  exact sum/count/min/max. Log buckets hold constant *relative* error, the
  right shape for latencies spanning µs prefills to multi-second
  compile-warm first steps.

``Registry.snapshot()`` returns a plain JSON-able dict. Snapshots MERGE
(``merge_snapshots``): counters and histogram buckets add, gauges take the
right operand, min/max widen — associative, so per-engine (or per-process)
snapshots can be combined in any grouping into one fleet view. Quantiles
(``hist_quantile``) are answered from bucket counts: the returned value is
the upper edge of the bucket holding the q-th observation, clamped to the
observed [min, max] — so it always lies within that bucket's bounds
(tests/test_torch_obs.py holds these properties under hypothesis, and
holds every function here equal to the reference's).

``render_prometheus`` emits the text exposition format (``/metrics``).
Metrics with no series yet are omitted entirely — an unavailable series
(e.g. predictor recall with telemetry off) simply never appears, it does
not render as a fake zero.
"""
from __future__ import annotations

import json
import math
import threading
from typing import Dict, List, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry",
    "merge_snapshots", "render_prometheus", "hist_quantile", "label_str",
]


def label_str(labels: Dict[str, str]) -> str:
    """Canonical label-set key: sorted ``k="v"`` pairs joined by commas
    (exactly what goes inside ``{}`` in the Prometheus exposition)."""
    if not labels:
        return ""
    return ",".join(f'{k}="{_escape(str(v))}"'
                    for k, v in sorted(labels.items()))


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, unit: str = ""):
        self.name = name
        self.help = help
        self.unit = unit
        self.series: Dict[str, object] = {}

    def _meta(self) -> dict:
        return {"kind": self.kind, "help": self.help, "unit": self.unit}


class Counter(_Metric):
    """Monotonically non-decreasing labeled sum."""
    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name}: negative inc {value}")
        key = label_str(labels)
        self.series[key] = self.series.get(key, 0.0) + value

    def value(self, **labels) -> float:
        return float(self.series.get(label_str(labels), 0.0))

    def snapshot(self) -> dict:
        return {**self._meta(), "series": dict(self.series)}


class Gauge(_Metric):
    """Last-written labeled value."""
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self.series[label_str(labels)] = float(value)

    def value(self, **labels) -> Optional[float]:
        return self.series.get(label_str(labels))

    def snapshot(self) -> dict:
        return {**self._meta(), "series": dict(self.series)}


# geometric bucket edges shared by every histogram series of a metric.
# Defaults cover 10 µs .. ~160 s at 2x resolution — wide enough for both
# a sub-ms host-sync phase and a compile-dominated first step.
_DEF_LO = 1e-5
_DEF_FACTOR = 2.0
_DEF_N = 24


class Histogram(_Metric):
    """Log-bucketed labeled histogram. Bucket ``i`` counts observations
    ``<= bounds[i]``; one extra overflow bucket counts the rest (+Inf)."""
    kind = "histogram"

    def __init__(self, name: str, help: str, unit: str = "",
                 lo: float = _DEF_LO, factor: float = _DEF_FACTOR,
                 n_buckets: int = _DEF_N):
        super().__init__(name, help, unit)
        if lo <= 0 or factor <= 1 or n_buckets < 1:
            raise ValueError("histogram needs lo > 0, factor > 1, "
                             "n_buckets >= 1")
        self.bounds: List[float] = [lo * factor ** i
                                    for i in range(n_buckets)]

    def _new_series(self) -> dict:
        return {"buckets": [0] * (len(self.bounds) + 1), "sum": 0.0,
                "count": 0, "min": math.inf, "max": -math.inf}

    def observe(self, value: float, **labels) -> None:
        key = label_str(labels)
        s = self.series.get(key)
        if s is None:
            s = self.series[key] = self._new_series()
        i = _bucket_index(self.bounds, value)
        s["buckets"][i] += 1
        s["sum"] += value
        s["count"] += 1
        if value < s["min"]:
            s["min"] = value
        if value > s["max"]:
            s["max"] = value

    def quantile(self, q: float, **labels) -> Optional[float]:
        s = self.series.get(label_str(labels))
        if s is None or not s["count"]:
            return None
        return hist_quantile({"bounds": self.bounds, **s}, q)

    def count(self, **labels) -> int:
        s = self.series.get(label_str(labels))
        return int(s["count"]) if s else 0

    def snapshot(self) -> dict:
        return {**self._meta(), "bounds": list(self.bounds),
                "series": {k: {"buckets": list(v["buckets"]),
                               "sum": v["sum"], "count": v["count"],
                               "min": v["min"], "max": v["max"]}
                           for k, v in self.series.items()}}


def _bucket_index(bounds: List[float], value: float) -> int:
    """First bucket whose upper edge admits ``value`` (bisect over the
    geometric edges; the list is tiny, linear would do — bisect keeps it
    O(log n) even for fine-grained custom histograms)."""
    lo, hi = 0, len(bounds)
    while lo < hi:
        mid = (lo + hi) // 2
        if value <= bounds[mid]:
            hi = mid
        else:
            lo = mid + 1
    return lo  # == len(bounds) -> overflow bucket


def hist_quantile(series: dict, q: float) -> Optional[float]:
    """Quantile estimate from one histogram series snapshot (needs the
    metric's ``bounds`` spliced in, as ``Histogram.quantile`` and the
    snapshot helpers do). Returns the upper edge of the bucket containing
    the ceil(q*count)-th observation, clamped to the observed [min, max] —
    always within the true quantile's bucket, never outside the observed
    range. None when the series is empty."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile {q} outside [0, 1]")
    count = series["count"]
    if not count:
        return None
    rank = max(1, math.ceil(q * count))
    bounds = series["bounds"]
    acc = 0
    for i, c in enumerate(series["buckets"]):
        acc += c
        if acc >= rank:
            upper = bounds[i] if i < len(bounds) else math.inf
            return float(min(max(upper, series["min"]), series["max"]))
    return float(series["max"])  # pragma: no cover - acc always reaches


class Registry:
    """Named metrics, get-or-create. Creation is idempotent (same name →
    the existing metric, kind mismatch raises); a lock guards creation so
    the asyncio serve loop and a benchmark thread can share one registry,
    while the hot inc/observe path stays lock-free (CPython dict ops are
    atomic and every writer is the single engine/serve-loop thread)."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help: str, unit: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, unit, **kw)
            elif not isinstance(m, cls):
                raise ValueError(f"metric {name} already registered as "
                                 f"{m.kind}, not {cls.kind}")
            return m

    def counter(self, name: str, help: str = "", unit: str = "") -> Counter:
        return self._get(Counter, name, help, unit)

    def gauge(self, name: str, help: str = "", unit: str = "") -> Gauge:
        return self._get(Gauge, name, help, unit)

    def histogram(self, name: str, help: str = "", unit: str = "",
                  **kw) -> Histogram:
        return self._get(Histogram, name, help, unit, **kw)

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def snapshot(self) -> dict:
        """Plain JSON-able dict of every metric with at least one series."""
        return {name: m.snapshot() for name, m in self._metrics.items()
                if m.series}

    def render(self) -> str:
        return render_prometheus(self.snapshot())

    def reset(self) -> None:
        """Drop every series (metric definitions survive). For benchmark
        harnesses that warm an engine and then measure it: NOT part of the
        serving path — a live server's counters stay monotone."""
        for m in self._metrics.values():
            m.series.clear()


# ---------------------------------------------------------------------------
# snapshot-level operations (merge + exposition) — pure functions over the
# plain-dict snapshot format, so remote snapshots (JSON over the wire) are
# first-class citizens


def merge_snapshots(*snaps: dict) -> dict:
    """Merge snapshots into one: counters and histogram buckets ADD, gauges
    take the rightmost value, histogram min/max widen. Associative (and,
    for counters/histograms, commutative) — fold per-engine snapshots in
    any grouping; bucket/observation counts and min/max are exactly
    grouping-independent, float sums up to ulp rounding. Kind/bucket-
    geometry mismatches for a shared name raise."""
    out: dict = {}
    for snap in snaps:
        for name, m in snap.items():
            if name not in out:
                out[name] = json.loads(json.dumps(m))  # deep copy
                continue
            dst = out[name]
            if dst["kind"] != m["kind"]:
                raise ValueError(f"merge: {name} is {dst['kind']} vs "
                                 f"{m['kind']}")
            if m["kind"] == "gauge":
                dst["series"].update(m["series"])
            elif m["kind"] == "counter":
                for k, v in m["series"].items():
                    dst["series"][k] = dst["series"].get(k, 0.0) + v
            else:  # histogram
                if dst["bounds"] != m["bounds"]:
                    raise ValueError(f"merge: {name} bucket bounds differ")
                for k, s in m["series"].items():
                    d = dst["series"].get(k)
                    if d is None:
                        dst["series"][k] = json.loads(json.dumps(s))
                        continue
                    d["buckets"] = [a + b for a, b in zip(d["buckets"],
                                                          s["buckets"])]
                    d["sum"] += s["sum"]
                    d["count"] += s["count"]
                    d["min"] = min(d["min"], s["min"])
                    d["max"] = max(d["max"], s["max"])
    return out


def snapshot_quantile(snap: dict, name: str, q: float,
                      labels: str = "") -> Optional[float]:
    """Quantile from a (possibly merged) snapshot; None when absent."""
    m = snap.get(name)
    if m is None or m["kind"] != "histogram":
        return None
    s = m["series"].get(labels)
    if s is None or not s["count"]:
        return None
    return hist_quantile({"bounds": m["bounds"], **s}, q)


def _fmt(v: float) -> str:
    if v != v or v in (math.inf, -math.inf):  # NaN/Inf guards
        return {math.inf: "+Inf", -math.inf: "-Inf"}.get(v, "NaN")
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def render_prometheus(snap: dict) -> str:
    """Prometheus text exposition (version 0.0.4) of a snapshot. Series
    are ordered by label string so scrapes diff cleanly."""
    lines: List[str] = []
    for name in sorted(snap):
        m = snap[name]
        if not m["series"]:
            continue
        if m["help"]:
            lines.append(f"# HELP {name} {m['help']}")
        lines.append(f"# TYPE {name} {m['kind']}")
        if m["kind"] in ("counter", "gauge"):
            for key in sorted(m["series"]):
                lab = f"{{{key}}}" if key else ""
                lines.append(f"{name}{lab} {_fmt(m['series'][key])}")
            continue
        bounds = m["bounds"]
        for key in sorted(m["series"]):
            s = m["series"][key]
            acc = 0
            for i, c in enumerate(s["buckets"]):
                acc += c
                le = _fmt(bounds[i]) if i < len(bounds) else "+Inf"
                lab = f'{key},le="{le}"' if key else f'le="{le}"'
                lines.append(f"{name}_bucket{{{lab}}} {acc}")
            lab = f"{{{key}}}" if key else ""
            lines.append(f"{name}_sum{lab} {_fmt(s['sum'])}")
            lines.append(f"{name}_count{lab} {s['count']}")
    return "\n".join(lines) + ("\n" if lines else "")


def parse_prometheus(text: str) -> Dict[Tuple[str, str], float]:
    """Inverse of ``render_prometheus`` for scrape clients (the serve-smoke
    client): maps (metric_name, label_string) -> value. Histogram bucket /
    sum / count lines appear under their suffixed names."""
    out: Dict[Tuple[str, str], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        head, _, val = line.rpartition(" ")
        if not head:
            continue
        if "{" in head:
            name, _, rest = head.partition("{")
            labels = rest.rstrip("}")
        else:
            name, labels = head, ""
        try:
            out[(name, labels)] = float(val)
        except ValueError:
            continue
    return out
