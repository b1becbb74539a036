"""Dependency-free metrics registry: counters, gauges, histograms.

A batched verification pipeline lives or dies on amortization factors
(occupancy, flush latency, the share of host prep hidden behind the
card) that must be measurable in the running process, so the registry
is first-class.  The port's own copy of the JAX package's registry: the
same families render the same snapshot and the same Prometheus text.

Design constraints:
  * zero third-party deps (no prometheus_client);
  * cheap enough for hot paths: one dict hit + a locked float add;
  * safe under threads: verify flushes run on worker threads and the
    replay's producer thread, so every mutation takes the instrument's
    lock (a bare `+=` is a read-modify-write race);
  * bounded label cardinality: each family folds overflow label sets
    into a single ``<other>`` child once it reaches its cap.

Naming scheme: ``clntpu_<area>_<name>``, with Prometheus conventions
for suffixes (``_total`` counters, ``_seconds`` histograms).
Histograms use FIXED log-scale buckets so two snapshots taken days
apart diff cleanly.
"""
from __future__ import annotations

import math
import re
import threading

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# One child per distinct label-value tuple; past the cap everything
# folds into this sentinel so the registry stays bounded.
OVERFLOW_LABEL = "<other>"
DEFAULT_MAX_LABEL_SETS = 64


def log2_buckets(lo: float, hi: float) -> tuple[float, ...]:
    """Powers of two spanning [lo, hi] — the fixed log-scale ladder.
    Fixed boundaries (not adaptive) so snapshots diff bucket-by-bucket."""
    e0 = math.floor(math.log2(lo))
    e1 = math.ceil(math.log2(hi))
    return tuple(2.0 ** e for e in range(e0, e1 + 1))


# 1 µs .. ~128 s in powers of two: wide enough for both a single kernel
# dispatch and a cold-compile stall, 28 buckets.
DURATION_BUCKETS = log2_buckets(1e-6, 128.0)
# batch/occupancy-style size ladder: 1 .. 1Mi
SIZE_BUCKETS = log2_buckets(1.0, float(1 << 20))
# ratios in (0, 1]: 1/256 .. 1
RATIO_BUCKETS = log2_buckets(1.0 / 256.0, 1.0)


class Counter:
    """Monotone float counter."""

    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self.value += n

    def sample(self):
        return self.value


class Gauge:
    """Point-in-time value."""

    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self.value -= n

    def sample(self):
        return self.value


class Histogram:
    """Cumulative histogram with fixed upper bounds (Prometheus ``le``
    semantics: a bucket counts observations <= its bound; +Inf implied)."""

    __slots__ = ("_lock", "bounds", "counts", "sum", "count")

    def __init__(self, bounds: tuple[float, ...]):
        self._lock = threading.Lock()
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # last = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        # linear scan beats bisect for <32 buckets in CPython; bounded
        i = 0
        for i, b in enumerate(self.bounds):
            if v <= b:
                break
        else:
            i = len(self.bounds)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1

    def sample(self):
        with self._lock:
            # cumulative counts per Prometheus exposition
            cum, out = 0, []
            for b, c in zip(self.bounds, self.counts):
                cum += c
                out.append((b, cum))
            return {"buckets": out, "sum": self.sum,
                    "count": self.count}


_KINDS = {"counter": Counter, "gauge": Gauge}


class Family:
    """One named metric with 0+ label dimensions; children are created
    lazily per label-value tuple and folded into ``<other>`` at the cap."""

    def __init__(self, kind: str, name: str, help: str = "",
                 labelnames: tuple[str, ...] = (),
                 buckets: tuple[float, ...] = DURATION_BUCKETS,
                 max_label_sets: int = DEFAULT_MAX_LABEL_SETS):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self.kind = kind
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(buckets)
        self.max_label_sets = max_label_sets
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], object] = {}
        if not self.labelnames:
            self._children[()] = self._make()

    def _make(self):
        if self.kind == "histogram":
            return Histogram(self.buckets)
        return _KINDS[self.kind]()

    def labels(self, *values, **kv):
        """Child instrument for one label-value set; positional values
        follow labelnames order, keywords may name them explicitly."""
        if kv:
            if values:
                raise ValueError("positional and keyword labels mixed")
            values = tuple(str(kv[n]) for n in self.labelnames)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {values}")
        child = self._children.get(values)
        if child is not None:
            return child
        with self._lock:
            child = self._children.get(values)
            if child is not None:
                return child
            if len(self._children) >= self.max_label_sets:
                values = (OVERFLOW_LABEL,) * len(self.labelnames)
                child = self._children.get(values)
                if child is not None:
                    return child
            child = self._make()
            self._children[values] = child
            return child

    # unlabeled conveniences: family IS the instrument when labelnames=()
    def _solo(self):
        if self.labelnames:
            raise ValueError(f"{self.name} has labels {self.labelnames}; "
                             "use .labels(...)")
        return self._children[()]

    def inc(self, n: float = 1.0) -> None:
        self._solo().inc(n)

    def set(self, v: float) -> None:
        self._solo().set(v)

    def dec(self, n: float = 1.0) -> None:
        self._solo().dec(n)

    def observe(self, v: float) -> None:
        self._solo().observe(v)

    def collect(self) -> list[tuple[tuple[str, ...], object]]:
        with self._lock:
            items = list(self._children.items())
        return [(lv, child.sample()) for lv, child in items]


class Registry:
    """Named family table + collect/exposition surface.

    ``on_collect`` hooks run before every snapshot/render so pull-style
    sources (logring depth, queue sizes) publish fresh gauges without a
    push call on their own hot path.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, Family] = {}
        self._on_collect: list = []

    def _family(self, kind: str, name: str, help: str,
                labelnames, **kw) -> Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as {fam.kind}")
                if fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered with labels "
                        f"{fam.labelnames}, not {tuple(labelnames)}")
                buckets = kw.get("buckets")
                if buckets is not None and fam.buckets != tuple(buckets):
                    raise ValueError(
                        f"metric {name!r} already registered with "
                        "different buckets")
                return fam
            fam = Family(kind, name, help, tuple(labelnames), **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labelnames=(), **kw) -> Family:
        return self._family("counter", name, help, labelnames, **kw)

    def gauge(self, name: str, help: str = "",
              labelnames=(), **kw) -> Family:
        return self._family("gauge", name, help, labelnames, **kw)

    def histogram(self, name: str, help: str = "", labelnames=(),
                  buckets: tuple[float, ...] = DURATION_BUCKETS,
                  **kw) -> Family:
        return self._family("histogram", name, help, labelnames,
                            buckets=tuple(buckets), **kw)

    def on_collect(self, fn) -> None:
        if fn not in self._on_collect:
            self._on_collect.append(fn)

    def _run_hooks(self) -> None:
        for fn in list(self._on_collect):
            try:
                fn()
            except Exception:
                pass  # a broken gauge source must not break exposition

    def snapshot(self) -> dict:
        """JSON-able view of every family (the snapshot-diff format)."""
        self._run_hooks()
        out = {}
        with self._lock:
            fams = list(self._families.values())
        for fam in sorted(fams, key=lambda f: f.name):
            samples = []
            for lv, val in fam.collect():
                rec = {"labels": dict(zip(fam.labelnames, lv))}
                if fam.kind == "histogram":
                    rec.update(val)
                else:
                    rec["value"] = val
                samples.append(rec)
            out[fam.name] = {"kind": fam.kind, "help": fam.help,
                             "samples": samples}
        return {"metrics": out}

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        self._run_hooks()
        lines: list[str] = []
        with self._lock:
            fams = list(self._families.values())
        for fam in sorted(fams, key=lambda f: f.name):
            if fam.help:
                lines.append(f"# HELP {fam.name} {_esc_help(fam.help)}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for lv, val in fam.collect():
                base = _labelstr(fam.labelnames, lv)
                if fam.kind == "histogram":
                    for b, cum in val["buckets"]:
                        lines.append(
                            f"{fam.name}_bucket"
                            f"{_labelstr(fam.labelnames + ('le',), lv + (_fmt(b),))}"
                            f" {cum}")
                    lines.append(
                        f"{fam.name}_bucket"
                        f"{_labelstr(fam.labelnames + ('le',), lv + ('+Inf',))}"
                        f" {val['count']}")
                    lines.append(f"{fam.name}_sum{base} {_fmt(val['sum'])}")
                    lines.append(f"{fam.name}_count{base} {val['count']}")
                else:
                    lines.append(f"{fam.name}{base} {_fmt(val)}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Test isolation: drop every family and hook."""
        with self._lock:
            self._families.clear()
            self._on_collect.clear()


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _esc_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _esc_label(s: str) -> str:
    return (s.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _labelstr(names: tuple[str, ...], values: tuple[str, ...]) -> str:
    if not names:
        return ""
    inner = ",".join(f'{n}="{_esc_label(v)}"'
                     for n, v in zip(names, values))
    return "{" + inner + "}"
