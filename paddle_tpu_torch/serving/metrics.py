"""Dependency-free metrics registry for the serving engine.

Counterpart of ``paddle_tpu/serving/metrics.py``, stdlib only: the same
observations give the same ``scalars()``, the same ``to_prometheus()``
text and the same ``to_state()`` in both packages.  The engine's
``stats`` dict is a flat ledger read once at drain time; this module
gives per-request TTFT / time-between-token percentiles and queue / pool
time-series to route and schedule on:

  * :class:`Counter` — monotonic totals (terminals, preemptions,
    tokens);
  * :class:`Gauge` — point-in-time levels (pool occupancy, queue
    depth, budget utilization);
  * :class:`Histogram` — exponential ("log-linear") buckets with
    p50/p90/p99 readout, the same shape Prometheus client libraries use
    for latency: fixed memory, O(1) observe, quantiles by linear
    interpolation within the straddling bucket.  Exact min/max/sum ride
    along so readouts stay honest at small counts;
  * :class:`MetricsRegistry` — the namespace: get-or-create by name (+
    optional ``labels=`` dict: one instance per (name, labels)
    combination, rendered ``name{tenant="a"}`` in Prometheus and
    flattened ``name.tenant=a`` for TB scalars — the multi-tenant front
    end's per-tenant series), ``scalars()`` flattens everything
    (histograms expand to
    ``_count/_sum/_mean/_min/_max/_p50/_p90/_p99``) for the TensorBoard
    exporter, ``to_prometheus()`` emits the text exposition format
    (cumulative ``_bucket{le=...}`` lines, one HELP/TYPE per family),
    ``to_state()`` / ``from_state()`` make metrics survive engine
    snapshot/restore.

Exporters (both file-based, both dependency-free):

  * :class:`MetricsFileExporter` — periodic scalar flush through the
    hand-rolled :class:`~paddle_tpu_torch.utils.tensorboard.SummaryWriter`
    (one tag per scalar, ``step`` = engine step; ``tensorboard
    --logdir`` opens it directly) plus a Prometheus ``metrics.prom``
    text dump on close — the node-exporter "textfile collector" shape,
    so a real scrape pipeline picks it up without the engine growing an
    HTTP server.

Determinism: time-valued observations fed from the engine's injectable
clock (``serving/faults.py``'s virtual clock under a FaultPlan) make
histogram readouts bit-reproducible across chaos runs — asserted in
tests/test_torch_serving_faults.py.
"""

from __future__ import annotations

import math
import os
from bisect import bisect_left
from typing import Dict, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "MetricsFileExporter", "SLOTracker", "merge_registries",
           "cluster_prometheus", "aggregate_scalars"]


def _sanitize(name: str) -> str:
    """Prometheus metric names: [a-zA-Z_:][a-zA-Z0-9_:]*."""
    out = "".join(c if (c.isalnum() or c == "_") else "_" for c in name)
    return out if out and not out[0].isdigit() else "_" + out


def _escape_label(v: str) -> str:
    """Prometheus label-value escaping: backslash, quote, newline."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _canon_labels(labels) -> Tuple[Tuple[str, str], ...]:
    """Sorted (key, value) pairs — the canonical identity of a labeled
    series, so ``{"a": 1, "b": 2}`` and ``{"b": 2, "a": 1}`` name the
    same metric."""
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _prom_labels(labels, extra: str = "") -> str:
    """``{k="v",...}`` rendering (empty string for no labels); ``extra``
    appends a pre-rendered pair (the histogram ``le`` bound)."""
    parts = [f'{_sanitize(k)}="{_escape_label(v)}"'
             for k, v in _canon_labels(labels)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _scalar_suffix(labels) -> str:
    """Flat-tag rendering for TensorBoard scalars: ``name.tenant=a``."""
    return "".join(f".{k}={v}" for k, v in _canon_labels(labels))


def _series_key(name: str, labels) -> str:
    """Registry key: base name + canonical label rendering, so each
    (name, labels) combination is its own series."""
    return name + _prom_labels(labels)


class Counter:
    """Monotonic counter.  ``set_total`` exists ONLY for mirror-sync and
    snapshot-restore (the engine keeps some counters in lockstep with its
    ``stats`` ledger); user code should ``inc``."""

    __slots__ = ("name", "help", "labels", "value")

    kind = "counter"

    def __init__(self, name: str, help: str = "", labels=None):
        self.name = name
        self.help = help
        self.labels = dict(labels) if labels else {}
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def set_total(self, v: float) -> None:
        self.value = float(v)

    def scalars(self) -> Dict[str, float]:
        return {self.name + _scalar_suffix(self.labels): self.value}

    def to_state(self) -> dict:
        return {"kind": self.kind, "help": self.help, "name": self.name,
                "labels": dict(self.labels), "value": self.value}

    def load_state(self, st: dict) -> None:
        self.value = float(st["value"])


class Gauge:
    """Point-in-time level; ``set`` replaces, ``inc``/``dec`` adjust."""

    __slots__ = ("name", "help", "labels", "value")

    kind = "gauge"

    def __init__(self, name: str, help: str = "", labels=None):
        self.name = name
        self.help = help
        self.labels = dict(labels) if labels else {}
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n

    def scalars(self) -> Dict[str, float]:
        return {self.name + _scalar_suffix(self.labels): self.value}

    def to_state(self) -> dict:
        return {"kind": self.kind, "help": self.help, "name": self.name,
                "labels": dict(self.labels), "value": self.value}

    def load_state(self, st: dict) -> None:
        self.value = float(st["value"])


class Histogram:
    """Exponential-bucket histogram with quantile readout.

    Bucket upper bounds grow geometrically: ``start * factor**i`` for
    ``n_buckets`` finite buckets plus the +Inf overflow — the default
    (100µs .. ~28min at factor 2) covers every latency the engine can
    produce, with ~2x relative quantile error (one factor step), tight
    enough to schedule on.  ``quantile`` finds the straddling bucket by
    cumulative rank and interpolates linearly inside it, clamped to the
    exact observed min/max so tiny samples don't report a bound nobody
    measured.
    """

    __slots__ = ("name", "help", "labels", "bounds", "counts", "count",
                 "sum", "min", "max")

    kind = "histogram"

    def __init__(self, name: str, help: str = "", start: float = 1e-4,
                 factor: float = 2.0, n_buckets: int = 24, labels=None):
        if start <= 0 or factor <= 1.0 or n_buckets < 1:
            raise ValueError("need start > 0, factor > 1, n_buckets >= 1")
        self.name = name
        self.help = help
        self.labels = dict(labels) if labels else {}
        self.bounds: List[float] = [start * factor ** i
                                    for i in range(n_buckets)]
        self.counts: List[int] = [0] * (n_buckets + 1)  # last = +Inf
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def quantile(self, q: float) -> float:
        """q in [0, 1].  0.0 with no observations (a readout, not NaN)."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank and c > 0:
                hi = (self.bounds[i] if i < len(self.bounds)
                      else self.max)
                lo = self.bounds[i - 1] if i > 0 else 0.0
                # linear interpolation of the rank within the bucket
                frac = 1.0 - (cum - rank) / c
                est = lo + (hi - lo) * frac
                return min(max(est, self.min), self.max)
        return self.max

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def scalars(self) -> Dict[str, float]:
        n, sfx = self.name, _scalar_suffix(self.labels)
        return {f"{n}_count{sfx}": float(self.count),
                f"{n}_sum{sfx}": self.sum,
                f"{n}_mean{sfx}": self.mean,
                f"{n}_min{sfx}": self.min if self.min is not None else 0.0,
                f"{n}_max{sfx}": self.max if self.max is not None else 0.0,
                f"{n}_p50{sfx}": self.quantile(0.50),
                f"{n}_p90{sfx}": self.quantile(0.90),
                f"{n}_p99{sfx}": self.quantile(0.99)}

    def to_state(self) -> dict:
        return {"kind": self.kind, "help": self.help, "name": self.name,
                "labels": dict(self.labels),
                "bounds": list(self.bounds), "counts": list(self.counts),
                "count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max}

    def load_state(self, st: dict) -> None:
        self.bounds = [float(b) for b in st["bounds"]]
        self.counts = [int(c) for c in st["counts"]]
        self.count = int(st["count"])
        self.sum = float(st["sum"])
        self.min = st["min"]
        self.max = st["max"]

    def merge(self, other: "Histogram") -> None:
        """Fold another histogram's buckets into this one element-wise —
        the cluster-quantile primitive: summed bucket counts over N
        replicas give the SAME quantile estimate a single histogram fed
        the union of samples would (identical bounds required; engines
        built from one config always share them)."""
        if self.bounds != other.bounds:
            raise ValueError(
                f"cannot merge {self.name!r}: bucket bounds differ")
        self.counts = [a + b for a, b in zip(self.counts, other.counts)]
        self.count += other.count
        self.sum += other.sum
        if other.min is not None:
            self.min = (other.min if self.min is None
                        else min(self.min, other.min))
        if other.max is not None:
            self.max = (other.max if self.max is None
                        else max(self.max, other.max))


class MetricsRegistry:
    """Get-or-create namespace of metrics, one per name.

    Re-requesting a name returns the SAME instance (a second caller
    asking for a different kind under an existing name is a programming
    error and raises) — so code observing ONE engine (its scheduler, a
    bench harness, a train loop using its own ``train_*`` names) can
    feed one registry without coordination.

    One engine per registry: the engine keeps its ``serving_*`` counters
    in lockstep with its stats ledger via ``set_total``, so TWO engines
    sharing a registry would overwrite each other's mirrored totals
    (last stepper wins) instead of aggregating.  Give each engine its
    own registry and sum ``scalars()`` downstream — that is the
    multi-replica aggregation shape (ROADMAP item 1).
    """

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._family_kind: Dict[str, str] = {}

    def __len__(self) -> int:
        return len(self._metrics)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def get(self, name: str, labels=None):
        return self._metrics.get(_series_key(name, labels))

    def _get_or_create(self, cls, name, help, labels=None, **kw):
        key = _series_key(name, labels)
        m = self._metrics.get(key)
        if m is None:
            # every labeled series of one FAMILY (base name) must share a
            # kind — Prometheus exposition emits one TYPE per family
            known = self._family_kind.get(name)
            if known is not None and known != cls.kind:
                raise ValueError(
                    f"metric {name!r} already registered as {known}")
            m = cls(name, help=help, labels=labels, **kw)
            self._metrics[key] = m
            self._family_kind[name] = cls.kind
        elif not isinstance(m, cls):
            raise ValueError(
                f"metric {name!r} already registered as {m.kind}")
        return m

    def counter(self, name: str, help: str = "", labels=None) -> Counter:
        """``labels={"tenant": "a"}`` makes this a labeled series:
        rendered ``name{tenant="a"}`` in the Prometheus exposition and
        flattened ``name.tenant=a`` in :meth:`scalars` — one instance
        per distinct (name, labels) combination."""
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", labels=None) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", start: float = 1e-4,
                  factor: float = 2.0, n_buckets: int = 24,
                  labels=None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   start=start, factor=factor,
                                   n_buckets=n_buckets)

    # -- readouts ---------------------------------------------------------

    def scalars(self) -> Dict[str, float]:
        """Every metric flattened to {tag: float} — the TensorBoard /
        bench-JSON surface.  Histograms expand to 8 derived tags."""
        out: Dict[str, float] = {}
        for m in self._metrics.values():
            out.update(m.scalars())
        return out

    def to_prometheus(self) -> str:
        """Text exposition format (one scrape page).  Histograms emit the
        standard cumulative ``_bucket{le="..."}`` series + ``_sum`` +
        ``_count``; +Inf is always present and equals ``_count``.
        Labeled series render ``name{k="v"}``; every series of one
        family emits CONTIGUOUSLY under a single HELP/TYPE header
        (lazily-created tenant series register interleaved, but the
        exposition format requires family grouping — strict parsers
        reject split families)."""
        families: Dict[str, List] = {}
        for m in self._metrics.values():
            families.setdefault(m.name, []).append(m)
        lines: List[str] = []
        for fam in families.values():
            name = _sanitize(fam[0].name)
            helps = [m.help for m in fam if m.help]
            if helps:
                lines.append(f"# HELP {name} {helps[0]}")
            lines.append(f"# TYPE {name} {fam[0].kind}")
            for m in fam:
                lines.extend(self._prom_series(name, m))
        return "\n".join(lines) + "\n"

    @staticmethod
    def _prom_series(name: str, m) -> List[str]:
        """The sample lines of ONE series (header emitted by caller)."""
        lines: List[str] = []
        lbl = _prom_labels(m.labels)
        if isinstance(m, Histogram):
            cum = 0
            for bound, c in zip(m.bounds, m.counts):
                cum += c
                le = _prom_labels(m.labels, f'le="{bound:.6g}"')
                lines.append(f"{name}_bucket{le} {cum}")
            inf = _prom_labels(m.labels, 'le="+Inf"')
            lines.append(f"{name}_bucket{inf} {m.count}")
            lines.append(f"{name}_sum{lbl} {m.sum:.9g}")
            lines.append(f"{name}_count{lbl} {m.count}")
        else:
            v = m.value
            lines.append(f"{name}{lbl} {int(v) if v == int(v) else v}")
        return lines

    # -- snapshot (serving/snapshot.py) -----------------------------------

    def to_state(self) -> dict:
        return {key: m.to_state() for key, m in self._metrics.items()}

    @classmethod
    def from_state(cls, state: dict) -> "MetricsRegistry":
        reg = cls()
        kinds = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}
        for key, st in state.items():
            # older states keyed by bare name and carried no labels
            name = st.get("name", key)
            m = kinds[st["kind"]](name, help=st.get("help", ""),
                                  labels=st.get("labels") or None)
            m.load_state(st)
            reg._metrics[key] = m
            reg._family_kind.setdefault(name, m.kind)
        return reg


class MetricsFileExporter:
    """TensorBoard scalar time-series + Prometheus textfile dump.

    ``flush(step)`` writes every ``registry.scalars()`` tag at ``step``
    into an event file under ``out_dir`` (open with ``tensorboard
    --logdir out_dir``); ``close()`` writes the final scrape page to
    ``out_dir/metrics.prom`` (Prometheus node-exporter textfile-collector
    format) and closes the event file.  Context-manager friendly.
    """

    def __init__(self, registry: MetricsRegistry, out_dir: str,
                 prom_name: str = "metrics.prom"):
        from ..utils.tensorboard import SummaryWriter

        self.registry = registry
        self.out_dir = out_dir
        self.prom_path = os.path.join(out_dir, prom_name)
        self.writer = SummaryWriter(out_dir)
        self.last_step = -1

    def flush(self, step: int) -> None:
        self.last_step = step
        for tag, v in self.registry.scalars().items():
            if math.isfinite(v):
                self.writer.add_scalar(tag, v, step=step)
        self.writer.flush()

    def dump_prometheus(self) -> str:
        text = self.registry.to_prometheus()
        with open(self.prom_path, "w") as f:
            f.write(text)
        return self.prom_path

    def close(self) -> None:
        self.dump_prometheus()
        self.writer.close()

    def __enter__(self) -> "MetricsFileExporter":
        return self

    def __exit__(self, *a) -> None:
        self.close()


# -- multi-replica aggregation ----------------------------------------
#
# One engine per registry is a hard rule (set_total mirroring), so a
# routed fleet holds a DICT of registries — {"replica0": reg, ...} from
# Router.attach_metrics().  These two functions are the sanctioned ways
# to read that dict as one thing: a labeled scrape page, or a rolled-up
# scalar table.


def cluster_prometheus(parts: Dict[str, "MetricsRegistry"]) -> str:
    """One Prometheus scrape page over per-replica registries: every
    series gains a ``replica="<key>"`` label, and every family still
    renders contiguously under a single HELP/TYPE header (strict parsers
    reject split families).  Replica keys iterate sorted, so the page is
    deterministic for a given fleet state."""
    import copy

    families: Dict[str, List] = {}
    for rep in sorted(parts):
        for m in parts[rep]._metrics.values():
            mm = copy.copy(m)
            mm.labels = {**m.labels, "replica": str(rep)}
            families.setdefault(m.name, []).append(mm)
    lines: List[str] = []
    for fam in families.values():
        name = _sanitize(fam[0].name)
        helps = [m.help for m in fam if m.help]
        if helps:
            lines.append(f"# HELP {name} {helps[0]}")
        lines.append(f"# TYPE {name} {fam[0].kind}")
        for m in fam:
            lines.extend(MetricsRegistry._prom_series(name, m))
    return "\n".join(lines) + "\n"


def merge_registries(parts: Dict[str, "MetricsRegistry"]
                     ) -> MetricsRegistry:
    """Fold per-replica registries into ONE merged registry: counters
    and gauges sum values, histograms sum bucket counts element-wise
    (:meth:`Histogram.merge`) and combine exact min/max — so quantiles
    read off the merged registry are REAL cluster quantiles, identical
    to a single registry fed the union of samples (up to the shared
    bucket resolution; asserted against that oracle in
    tests/test_torch_observability.py).  Replica keys iterate sorted, so the
    result is deterministic.  The merged registry is a read-only
    rollup — don't attach an engine to it."""
    kinds = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}
    merged = MetricsRegistry()
    for rep in sorted(parts):
        for key, m in parts[rep]._metrics.items():
            cur = merged._metrics.get(key)
            if cur is None:
                st = m.to_state()
                mm = kinds[st["kind"]](m.name, help=m.help,
                                       labels=m.labels or None)
                mm.load_state(st)
                merged._metrics[key] = mm
                merged._family_kind.setdefault(m.name, m.kind)
            elif cur.kind != m.kind:
                raise ValueError(
                    f"metric {m.name!r} is {cur.kind} on one replica "
                    f"and {m.kind} on another")
            elif isinstance(cur, Histogram):
                cur.merge(m)
            else:
                cur.value += m.value
    return merged


def aggregate_scalars(parts: Dict[str, "MetricsRegistry"]
                      ) -> Dict[str, float]:
    """Cluster rollup of per-replica registries as one scalar table:
    counters and gauges SUM across replicas; histogram buckets merge
    element-wise so ``_p50``/``_p90``/``_p99`` are REAL cluster
    quantiles , ``_min`` /
    ``_max`` combine exactly, and ``_mean`` is the merged sum/count.
    Ratio gauges (hit rate, budget utilization) still sum like any
    gauge: divide by the replica count, or read the per-replica
    registries, when you want the level."""
    return merge_registries(parts).scalars()


# -- SLO attainment + burn rate ----------------------------------------


class _RollingWindow:
    """Bucketed rolling good/bad tally on an injectable clock.

    ``n_buckets`` fixed slots of ``window_s / n_buckets`` seconds each,
    recycled by epoch number — O(1) observe, O(n_buckets) readout, no
    timestamps stored, fully deterministic under the chaos virtual
    clock.  A slot whose epoch fell out of the window reads as empty
    (and is zeroed on reuse), so the tally always covers the trailing
    ``window_s`` seconds to bucket resolution."""

    __slots__ = ("window_s", "n_buckets", "bucket_s", "good", "bad",
                 "epoch")

    def __init__(self, window_s: float, n_buckets: int = 30):
        self.window_s = float(window_s)
        self.n_buckets = int(n_buckets)
        self.bucket_s = self.window_s / self.n_buckets
        self.good = [0] * self.n_buckets
        self.bad = [0] * self.n_buckets
        self.epoch: List[Optional[int]] = [None] * self.n_buckets

    def _slot(self, now: float) -> int:
        e = int(now // self.bucket_s)
        i = e % self.n_buckets
        if self.epoch[i] != e:
            self.epoch[i] = e
            self.good[i] = 0
            self.bad[i] = 0
        return i

    def observe(self, now: float, ok: bool) -> None:
        i = self._slot(now)
        if ok:
            self.good[i] += 1
        else:
            self.bad[i] += 1

    def bad_fraction(self, now: float) -> float:
        e_now = int(now // self.bucket_s)
        good = bad = 0
        for i in range(self.n_buckets):
            e = self.epoch[i]
            if e is not None and 0 <= e_now - e < self.n_buckets:
                good += self.good[i]
                bad += self.bad[i]
        total = good + bad
        return bad / total if total else 0.0


class SLOTracker:
    """Per-tenant SLO attainment + multi-window burn rate.

    The SRE error-budget idiom: for each (tenant, slo-kind) pair track
    lifetime attainment (``serving_slo_attainment{tenant=,slo=}``, the
    fraction of requests inside budget) and TWO rolling windows —
    ``fast`` (1-min-equivalent, pages quickly) and ``slow``
    (1-hr-equivalent, resists flapping) — whose **burn rate** is the
    window's bad fraction divided by the error budget
    ``1 - objective``; burn > 1 means the budget is being spent faster
    than the objective allows.  All series register lazily in the
    engine's registry, so tenants without SLOs cost nothing; all time
    comes from the engine clock, so chaos replays are deterministic.
    """

    FAST_WINDOW_S = 60.0
    SLOW_WINDOW_S = 3600.0

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        self._series: Dict[tuple, dict] = {}

    def _get(self, tenant: str, kind: str, objective: float) -> dict:
        key = (tenant, kind)
        s = self._series.get(key)
        if s is None:
            lb = {"tenant": tenant, "slo": kind}
            reg = self.registry
            s = {
                "total": reg.counter(
                    "serving_slo_total",
                    "requests evaluated against this SLO", labels=lb),
                "miss": reg.counter(
                    "serving_slo_miss",
                    "requests that missed their SLO budget", labels=lb),
                "attain": reg.gauge(
                    "serving_slo_attainment",
                    "lifetime fraction of requests inside the SLO "
                    "budget", labels=lb),
                "burn_fast": reg.gauge(
                    "serving_slo_burn_rate",
                    "windowed bad-fraction / error budget; > 1 burns "
                    "the budget faster than the objective allows",
                    labels={**lb, "window": "fast"}),
                "burn_slow": reg.gauge(
                    "serving_slo_burn_rate", "",
                    labels={**lb, "window": "slow"}),
                "fast": _RollingWindow(self.FAST_WINDOW_S),
                "slow": _RollingWindow(self.SLOW_WINDOW_S),
                "objective": float(objective),
            }
            self._series[key] = s
        return s

    def observe(self, tenant: str, kind: str, ok: bool, now: float,
                objective: float) -> None:
        """Record one terminal's verdict against one SLO kind."""
        s = self._get(tenant, kind, objective)
        s["total"].inc()
        if not ok:
            s["miss"].inc()
        s["attain"].set(1.0 - s["miss"].value / s["total"].value)
        s["fast"].observe(now, ok)
        s["slow"].observe(now, ok)

    def sync(self, now: float) -> None:
        """Refresh the burn-rate gauges at ``now`` (called per step —
        windows page OUT even when no new terminals arrive)."""
        for s in self._series.values():
            budget = max(1.0 - s["objective"], 1e-9)
            s["burn_fast"].set(s["fast"].bad_fraction(now) / budget)
            s["burn_slow"].set(s["slow"].bad_fraction(now) / budget)
