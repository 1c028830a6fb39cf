"""Metrics registry: counters, gauges and log2-bucket histograms behind
one schema, replacing the serving layers' ad-hoc ``stats()`` dicts for
SLO accounting.

Design
------
* **Fixed log2 buckets, µs -> s.**  Every histogram shares the bucket
  ladder ``1 µs, 2 µs, 4 µs, ..., 2^21 µs (~2.1 s), +inf`` — wide enough
  for a kernel dispatch and a full-fleet snapshot pass on the same axis,
  and *fixed*, so histograms from different runs/shards merge by adding
  count vectors.  Observation is one ``searchsorted`` (scalar or
  vectorized for columnar emission paths).
* **Wall-clock tagging.**  A metric created with ``wallclock=True``
  (latency histograms, deadline-miss counters) is intrinsically
  nondeterministic; ``snapshot(deterministic=True)`` drops those and
  keeps the deterministic skeleton — that is the byte-stable surface CI
  compares across identical runs.
* **Exporters.**  ``snapshot()`` emits one canonical JSON-able dict
  (``benchmark: "metrics_snapshot"`` so ``benchmarks/validate_bench.py``
  schema-gates it like every other artifact); ``prometheus()`` renders
  the standard text exposition format (counters, gauges, cumulative
  ``_bucket``/``_sum``/``_count`` histogram series).

The registry is plain Python + NumPy with no locks: the serving stack is
single-threaded per process, and the fleet engine owns exactly one
registry (shard-level series are name-prefixed, e.g.
``fleet.shard3.deadline_miss_stream_ticks``).
"""
from __future__ import annotations

import json
from typing import Any, Iterable

import numpy as np

#: Schema version of the snapshot artifact (bump on breaking change).
SNAPSHOT_SCHEMA_VERSION = 1

#: Shared histogram bucket upper edges in µs: 2^0 .. 2^21 (~2.1 s).
#: Observations above the last edge land in the +inf overflow bucket.
BUCKET_EDGES_US: tuple[int, ...] = tuple(2 ** k for k in range(22))


class Counter:
    """Monotonic counter."""
    __slots__ = ("name", "help", "wallclock", "value")

    def __init__(self, name: str, help: str = "", wallclock: bool = False):
        self.name = name
        self.help = help
        self.wallclock = wallclock
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""
    __slots__ = ("name", "help", "wallclock", "value")

    def __init__(self, name: str, help: str = "", wallclock: bool = False):
        self.name = name
        self.help = help
        self.wallclock = wallclock
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed log2-bucket histogram over µs (see :data:`BUCKET_EDGES_US`).

    ``counts[i]`` is the number of observations with
    ``value <= BUCKET_EDGES_US[i]`` (non-cumulative, per-bucket);
    ``counts[-1]`` is the +inf overflow.  ``sum_us`` accumulates exactly,
    so means are available alongside the bucketed percentiles."""
    __slots__ = ("name", "help", "wallclock", "counts", "sum_us", "count")

    def __init__(self, name: str, help: str = "", wallclock: bool = False):
        self.name = name
        self.help = help
        self.wallclock = wallclock
        self.counts = np.zeros(len(BUCKET_EDGES_US) + 1, np.int64)
        self.sum_us = 0.0
        self.count = 0

    def observe_us(self, us: float) -> None:
        i = int(np.searchsorted(_EDGES, us, side="left"))
        self.counts[i] += 1
        self.sum_us += us
        self.count += 1

    def observe_ns(self, ns: int) -> None:
        self.observe_us(ns / 1e3)

    def observe_many_us(self, us: np.ndarray) -> None:
        """Vectorized observation (columnar emission / warm-up sweeps)."""
        us = np.asarray(us, np.float64).ravel()
        if us.size == 0:
            return
        idx = np.searchsorted(_EDGES, us, side="left")
        np.add.at(self.counts, idx, 1)
        self.sum_us += float(us.sum())
        self.count += int(us.size)

    def quantile_us(self, q: float) -> float:
        """Bucket-resolution quantile estimate (upper edge of the bucket
        holding the q-th observation; +inf overflow reports the top edge
        doubled so it stays finite and obviously saturated)."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        cum = np.cumsum(self.counts)
        i = int(np.searchsorted(cum, target, side="left"))
        if i >= len(BUCKET_EDGES_US):
            return float(BUCKET_EDGES_US[-1] * 2)
        return float(BUCKET_EDGES_US[i])


_EDGES = np.asarray(BUCKET_EDGES_US, np.float64)


class MetricsRegistry:
    """Name -> metric registry with get-or-create accessors and the two
    exporters.  Metric kinds are namespaced separately is an error —
    re-registering a name as a different kind raises."""

    def __init__(self):
        self._metrics: dict[str, Any] = {}

    # -- get-or-create -------------------------------------------------
    def counter(self, name: str, help: str = "",
                wallclock: bool = False) -> Counter:
        return self._get(name, Counter, help, wallclock)

    def gauge(self, name: str, help: str = "",
              wallclock: bool = False) -> Gauge:
        return self._get(name, Gauge, help, wallclock)

    def histogram(self, name: str, help: str = "",
                  wallclock: bool = False) -> Histogram:
        return self._get(name, Histogram, help, wallclock)

    def _get(self, name, cls, help, wallclock):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, help, wallclock)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not {cls.__name__}")
        return m

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def names(self) -> list[str]:
        return sorted(self._metrics)

    # -- exporters -----------------------------------------------------
    def snapshot(self, deterministic: bool = False) -> dict[str, Any]:
        """One canonical dict of every metric, names sorted.
        ``deterministic=True`` drops wall-clock-tagged metrics so two
        identical runs serialize byte-identically (CI's determinism
        gate); the default keeps everything."""
        counters: dict[str, int] = {}
        gauges: dict[str, float] = {}
        hists: dict[str, Any] = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if deterministic and m.wallclock:
                continue
            if isinstance(m, Counter):
                counters[name] = int(m.value)
            elif isinstance(m, Gauge):
                gauges[name] = float(m.value)
            else:
                hists[name] = {
                    "buckets_us": list(BUCKET_EDGES_US),
                    "counts": [int(c) for c in m.counts],
                    "count": int(m.count),
                    "sum_us": round(float(m.sum_us), 3),
                    "p50_us": m.quantile_us(0.50),
                    "p99_us": m.quantile_us(0.99),
                }
        return {
            "benchmark": "metrics_snapshot",
            "schema_version": SNAPSHOT_SCHEMA_VERSION,
            "deterministic": bool(deterministic),
            "counters": counters,
            "gauges": gauges,
            "histograms": hists,
        }

    def dumps(self, deterministic: bool = False) -> str:
        """Canonical JSON encoding of :meth:`snapshot` (sorted keys, no
        whitespace drift) — the byte-comparison surface."""
        return json.dumps(self.snapshot(deterministic=deterministic),
                          sort_keys=True, separators=(",", ":"))

    def prometheus(self) -> str:
        """Prometheus text exposition format.  Dots in metric names map
        to underscores (Prometheus name charset); histograms render the
        standard cumulative ``_bucket{le=...}`` series plus ``_sum`` and
        ``_count``."""
        lines: list[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            pname = _prom_name(name)
            if m.help:
                lines.append(f"# HELP {pname} {_prom_help(m.help)}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {pname} counter")
                lines.append(f"{pname} {m.value}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {pname} gauge")
                lines.append(f"{pname} {_prom_num(m.value)}")
            else:
                lines.append(f"# TYPE {pname} histogram")
                cum = 0
                for edge, c in zip(BUCKET_EDGES_US, m.counts):
                    cum += int(c)
                    lines.append(f'{pname}_bucket{{le="{edge}"}} {cum}')
                cum += int(m.counts[-1])
                lines.append(f'{pname}_bucket{{le="+Inf"}} {cum}')
                lines.append(f"{pname}_sum {_prom_num(m.sum_us)}")
                lines.append(f"{pname}_count {m.count}")
        return "\n".join(lines) + "\n"


def _prom_name(name: str) -> str:
    """Sanitize into the Prometheus metric-name charset
    ``[a-zA-Z_:][a-zA-Z0-9_:]*``: every other character maps to ``_``,
    and a leading digit gets an underscore prefix (``isalnum`` admits
    digits everywhere *but* position 0)."""
    out = "".join(c if (c.isalnum() and c.isascii()) or c in "_:" else "_"
                  for c in name)
    return "_" + out if out[:1].isdigit() else out


def _prom_help(text: str) -> str:
    """Escape a HELP string per the text exposition format: backslash
    and newline are the only characters escaped on HELP lines."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _prom_num(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() else repr(float(v))


def validate_snapshot(record: dict) -> list[str]:
    """Schema-gate one metrics snapshot (the ``validate_bench`` hook):
    required keys, bucket-ladder shape, count conservation, finiteness.
    Returns a list of errors; empty = valid."""
    errors: list[str] = []
    for key in ("benchmark", "schema_version", "deterministic",
                "counters", "gauges", "histograms"):
        if key not in record:
            errors.append(f"missing top-level key {key!r}")
    if errors:
        return errors
    if record["benchmark"] != "metrics_snapshot":
        errors.append(f"benchmark must be 'metrics_snapshot', "
                      f"got {record['benchmark']!r}")
    if record["schema_version"] != SNAPSHOT_SCHEMA_VERSION:
        errors.append(f"schema_version {record['schema_version']!r} != "
                      f"{SNAPSHOT_SCHEMA_VERSION}")
    for name, v in record["counters"].items():
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            errors.append(f"counter {name!r}: must be a non-negative int, "
                          f"got {v!r}")
    for name, v in record["gauges"].items():
        if not isinstance(v, (int, float)) or isinstance(v, bool) \
                or not np.isfinite(v):
            errors.append(f"gauge {name!r}: must be a finite number")
    for name, h in record["histograms"].items():
        for key in ("buckets_us", "counts", "count", "sum_us",
                    "p50_us", "p99_us"):
            if key not in h:
                errors.append(f"histogram {name!r}: missing {key!r}")
        if sorted(h) != sorted(("buckets_us", "counts", "count", "sum_us",
                                "p50_us", "p99_us")):
            continue
        if list(h["buckets_us"]) != list(BUCKET_EDGES_US):
            errors.append(f"histogram {name!r}: bucket ladder differs from "
                          f"the canonical log2 edges")
        if len(h["counts"]) != len(BUCKET_EDGES_US) + 1:
            errors.append(f"histogram {name!r}: counts length "
                          f"{len(h['counts'])} != {len(BUCKET_EDGES_US) + 1}")
        elif sum(h["counts"]) != h["count"]:
            errors.append(f"histogram {name!r}: bucket counts sum "
                          f"{sum(h['counts'])} != count {h['count']}")
        if any((not isinstance(c, int)) or isinstance(c, bool) or c < 0
               for c in h["counts"]):
            errors.append(f"histogram {name!r}: counts must be "
                          f"non-negative ints")
    return errors


def merge_histogram_counts(counts: Iterable[Iterable[int]]) -> list[int]:
    """Merge per-shard histograms sharing the fixed bucket ladder by
    summing count vectors (the property the fixed edges exist for)."""
    out = np.zeros(len(BUCKET_EDGES_US) + 1, np.int64)
    for c in counts:
        c = np.asarray(list(c), np.int64)
        if c.shape != out.shape:
            raise ValueError(f"histogram counts length {c.shape[0]} != "
                             f"{out.shape[0]}")
        out += c
    return [int(v) for v in out]
