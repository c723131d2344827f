# Copied from apex_tpu/prof/slo.py (stdlib only), so the port imports
# nothing of the JAX package; alerts without a logger go to the port's
# prof.metrics.note_kind, as the JAX module's go to its own.
"""In-run SLO monitoring — rolling-window rules that ALERT during the run.

Everything in prof.metrics is post-hoc: a violated latency budget is
discovered when someone reads the sidecar. The ROADMAP's self-healing
fleet runtime needs the opposite seam — detect → alert → (eventually)
remediate *while the run is alive* (TorchTitan, arXiv:2410.06511,
treats this loop as a first-class production subsystem). This module is
the detect→alert half: declarative rules over rolling windows of
observed metrics, emitting schema-5 ``alert`` telemetry records plus a
registered-callback seam the remediation runtime will consume.

Rule syntax (one spec, comma/semicolon-separated lists)::

    <name><=THRESHOLD[@WINDOW]     # upper bound (the usual SLO shape)
    <name>>=THRESHOLD[@WINDOW]     # lower bound (throughput floors)

``name`` resolves to (metric, aggregation):

- ``<metric>_pNN_ms``  -> percentile NN over the ``<metric>_ms`` window
  (``ttft_p95_ms``, ``token_lat_p99_ms``, ``step_p95_ms``, ...)
- ``*_rate`` / ``*_share`` -> mean of the identically-named metric
  (``skip_rate``, ``input_wait_share``)
- ``<metric>_mean`` / ``<metric>_max`` -> mean/max of ``<metric>``
- anything else          -> mean of the metric named exactly

``WINDOW`` is the rolling sample count (default 64). Evaluation is
debounced per violation *episode*: one alert when a rule first trips,
re-armed only after a later evaluation passes — a sustained violation
is one incident, not one alert per sample.

Producers call :meth:`SLOMonitor.observe` at their natural cadence
(the serve engine per request/step, the benches per interval); the
monitor never syncs a device value itself.
"""

from __future__ import annotations

import dataclasses
import re
from collections import deque
from typing import Callable, Optional

__all__ = ["SLORule", "SLOMonitor", "parse_rules", "resolve_rule_name"]

DEFAULT_WINDOW = 64

_SPEC_RE = re.compile(
    r"^\s*([A-Za-z][A-Za-z0-9_]*)\s*(<=|>=)\s*"
    r"([0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?)\s*(?:@\s*([0-9]+))?\s*$")
_PCT_RE = re.compile(r"^(.+)_p([0-9]{1,2})_ms$")
_AGG_RE = re.compile(r"^(.+)_(mean|max|p[0-9]{1,2})$")


def resolve_rule_name(name: str) -> "tuple[str, str]":
    """``rule name -> (metric, agg)`` per the module grammar."""
    m = _PCT_RE.match(name)
    if m:
        return f"{m.group(1)}_ms", f"p{int(m.group(2))}"
    if name.endswith(("_rate", "_share")):
        return name, "mean"
    m = _AGG_RE.match(name)
    if m:
        return m.group(1), m.group(2)
    return name, "mean"


@dataclasses.dataclass(frozen=True)
class SLORule:
    """One declarative SLO: ``agg(window of metric) op threshold``."""
    name: str          # as written in the spec ("ttft_p95_ms")
    metric: str        # observed metric key ("ttft_ms")
    agg: str           # "pNN" | "mean" | "max"
    op: str            # "<=" | ">="
    threshold: float
    window: int = DEFAULT_WINDOW

    def violated(self, measured: float) -> bool:
        return (measured > self.threshold if self.op == "<="
                else measured < self.threshold)


def parse_rules(spec, default_window: int = DEFAULT_WINDOW
                ) -> "list[SLORule]":
    """Parse a rule-spec string (or pass through a rule list)."""
    if not spec:
        return []
    if not isinstance(spec, str):
        rules = list(spec)
        if not all(isinstance(r, SLORule) for r in rules):
            raise ValueError("rules must be SLORule instances or a spec "
                             "string")
        return rules
    rules = []
    for part in re.split(r"[,;]", spec):
        if not part.strip():
            continue
        m = _SPEC_RE.match(part)
        if not m:
            raise ValueError(
                f"bad SLO rule {part.strip()!r}: expected "
                f"name<=THRESHOLD[@WINDOW] or name>=THRESHOLD[@WINDOW] "
                f"(e.g. ttft_p95_ms<=250@64)")
        name, op, thresh, window = m.groups()
        metric, agg = resolve_rule_name(name)
        w = int(window) if window else default_window
        if w < 1:
            raise ValueError(f"bad SLO rule {part.strip()!r}: window "
                             f"must be >= 1")
        rules.append(SLORule(name=name, metric=metric, agg=agg, op=op,
                             threshold=float(thresh), window=w))
    if not rules:
        raise ValueError(f"empty SLO spec {spec!r}")
    names = [r.name for r in rules]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate SLO rule names in {spec!r}")
    return rules


def _percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile (the traffic/telemetry_report rule)."""
    idx = min(len(sorted_vals) - 1,
              max(0, round(q / 100.0 * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


class SLOMonitor:
    """Evaluate :class:`SLORule` s over rolling windows, in-run.

    ::

        mon = SLOMonitor("ttft_p95_ms<=250,step_p95_ms<=40",
                         logger=telem)
        mon.on_alert(lambda a: remediate(a))     # the runtime seam
        ...
        mon.observe("ttft_ms", ttft * 1e3)       # per request
        mon.observe("step_ms", dt_ms)            # per decode step

    Each ``observe`` feeds every rule watching that metric and
    evaluates it once the window holds ``min_samples`` values. A
    violation emits ONE ``alert`` record (``MetricsLogger.log_alert``,
    flushed immediately — an alert is an incident) carrying the rule
    name, window occupancy, measured value and threshold, and invokes
    every registered callback with the same payload; the episode
    re-arms when a later evaluation passes. Without a logger, alerts
    ride the :func:`prof.metrics.note_kind` pending channel so
    whichever MetricsLogger flushes next persists them.
    """

    def __init__(self, rules, *, logger=None, min_samples: int = 8,
                 source: str = "slo",
                 default_window: int = DEFAULT_WINDOW):
        self.rules = parse_rules(rules, default_window=default_window)
        self.logger = logger
        self.source = source
        self.min_samples = max(1, int(min_samples))
        self._win: dict = {r.name: deque(maxlen=r.window)
                           for r in self.rules}
        self._violating: dict = {r.name: False for r in self.rules}
        self._by_metric: dict = {}
        for r in self.rules:
            self._by_metric.setdefault(r.metric, []).append(r)
        self.alerts: list = []          # every alert payload, in order
        self._callbacks: list = []

    # -- the remediation seam ---------------------------------------------
    def on_alert(self, callback: Callable[[dict], None]) -> None:
        """Register a callback invoked with each alert payload — the
        seam the self-healing runtime (the JAX package's
        ``runtime.Supervisor`` is the first real consumer: r17) plugs a
        remediation into.
        Callback exceptions are swallowed: a broken remediator must not
        kill the run it was meant to save."""
        self._callbacks.append(callback)

    def reset(self) -> None:
        """Drop every rolling window and re-arm every violation
        episode — the post-restore hygiene call (r17): after a
        supervised rollback the windows are full of pre-restore
        samples, and evaluating the restored run against them would
        immediately re-trip the rule the restore just acted on.
        ``alerts`` history is kept (it is the run's incident log)."""
        for win in self._win.values():
            win.clear()
        for name in self._violating:
            self._violating[name] = False

    @property
    def metrics(self) -> "tuple[str, ...]":
        return tuple(self._by_metric)

    # -- feeding -----------------------------------------------------------
    def observe(self, metric: str, value, *, context: Optional[dict]
                = None) -> "list[dict]":
        """Feed one sample; returns any alerts it fired (usually [])."""
        rules = self._by_metric.get(metric)
        if not rules:
            return []
        v = float(value)
        fired = []
        for r in rules:
            win = self._win[r.name]
            win.append(v)
            a = self._evaluate(r, win, context)
            if a is not None:
                fired.append(a)
        return fired

    def check(self, *, context: Optional[dict] = None) -> "list[dict]":
        """Re-evaluate every rule on its current window (an explicit
        checkpoint — e.g. end of a bench interval)."""
        fired = []
        for r in self.rules:
            a = self._evaluate(r, self._win[r.name], context)
            if a is not None:
                fired.append(a)
        return fired

    def measured(self, name: str) -> "float | None":
        """Current aggregate of a rule's window (None until populated)."""
        (r,) = [r for r in self.rules if r.name == name]
        win = self._win[name]
        return self._aggregate(r, win) if win else None

    # -- internals ---------------------------------------------------------
    @staticmethod
    def _aggregate(rule: SLORule, win) -> float:
        vals = list(win)
        if rule.agg == "mean":
            return sum(vals) / len(vals)
        if rule.agg == "max":
            return max(vals)
        return _percentile(sorted(vals), float(rule.agg[1:]))

    def _evaluate(self, rule: SLORule, win, context) -> "dict | None":
        if len(win) < min(self.min_samples, rule.window):
            return None
        measured = self._aggregate(rule, win)
        if not rule.violated(measured):
            self._violating[rule.name] = False   # episode over: re-arm
            return None
        if self._violating[rule.name]:
            return None                          # already alerted
        self._violating[rule.name] = True
        alert = {"rule": rule.name, "metric": rule.metric,
                 "agg": rule.agg, "op": rule.op,
                 "threshold": rule.threshold,
                 "measured": round(measured, 4),
                 "window": len(win), "window_size": rule.window,
                 "source": self.source}
        if context:
            alert.update(context)
        self.alerts.append(alert)
        if self.logger is not None:
            try:
                self.logger.log_alert(**alert)
            except Exception:
                pass
        else:
            from apex_tpu_torch.prof import metrics as _m
            _m.note_kind("alert", **alert)
        for cb in self._callbacks:
            try:
                cb(alert)
            except Exception:
                pass
        return alert

    def summary(self) -> dict:
        """The JSON-line payload: rule census + violation counts."""
        return {
            "rules": [r.name for r in self.rules],
            "alerts": len(self.alerts),
            "violated": sorted({a["rule"] for a in self.alerts}),
        }
