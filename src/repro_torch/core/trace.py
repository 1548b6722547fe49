"""Unified cross-tier span/event tracer (DESIGN.md §17).

Every layer of the checkpoint stack times itself — ``SaveMetrics``,
``RestoreMetrics``, ``TransferStats``, ``RangeStats``, ``FlushStats`` —
but each slice lives on its own clock with no causal linkage, so "where
did the 96 MB save spend its 95 ms" has no end-to-end answer. This module
is the shared instrument:

  · one process-wide monotonic epoch (``clock()``): every timestamp in the
    stack is seconds since the same instant, so spans recorded on the
    pipeline worker, the io_uring reaper, the level-1 flush thread, and the
    rget pool land on one comparable timeline,
  · spans carry ``(name, tier, bytes, attrs, parent)``; events are instant
    marks (hedge issue/win, injected faults); counters/histograms aggregate,
  · per-thread ring buffers — appends touch only thread-local state (no
    lock on the hot path); overflow drops the OLDEST events and counts the
    drops, so a long soak degrades to "recent history" instead of OOM,
  · a module-level no-op fast path: when no tracer is installed, ``span()``
    returns a shared singleton and ``event()``/``count()`` return
    immediately — O(100 ns), no allocation — so instrumentation stays
    compiled into hot loops permanently,
  · two exporters: Chrome/Perfetto ``trace.json`` (spans as ``X`` events on
    tier-named tracks — open in ui.perfetto.dev, pipeline overlap is
    visually inspectable) and a Prometheus-style textfile of
    counters/histograms,
  · ``MetricsRegistry``: adapts the stack's existing Stats dataclasses
    (live, by reference — no copy at registration) into one queryable tree,
  · ``stall_report()``: attributes a save/restore span's wall time to
    {compute, d2h, stage_wait, level0_write, level1_flush, remote_put,
    remote_get, barrier} by same-thread span self-times, so the attribution
    sums to the wall exactly, and names the top bottleneck.

This module must stay stdlib-only and import-light: ``faults`` emits into
it from inside syscall shims and ``crlint`` mandates ``trace.clock()`` as
the one timing primitive in ``core/**`` (CRL006).
"""

from __future__ import annotations

import itertools
import json
import re
import threading
import time
from dataclasses import dataclass, fields as _dc_fields, is_dataclass

# --------------------------------------------------------------------- clock
# The process trace epoch: set once at import, shared by every thread. All
# core/** timing paths call clock() instead of raw time.perf_counter() so
# durations AND absolute span timestamps from different threads are
# comparable on one exported timeline (CRL006 enforces this).
_EPOCH = time.perf_counter()


def clock() -> float:
    """Monotonic seconds since the process trace epoch."""
    return time.perf_counter() - _EPOCH


@dataclass(slots=True)
class TraceEvent:
    """One recorded span ('X'), instant event ('i'), or counter sample."""
    kind: str             # "span" | "instant"
    name: str
    tier: str
    t0: float             # clock() seconds
    t1: float
    nbytes: int
    span_id: int
    parent_id: int
    tid: int
    thread: str
    attrs: dict | None

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


class _Ring:
    """Fixed-capacity per-thread event ring: overwrite drops the oldest."""

    __slots__ = ("buf", "cap", "n", "dropped", "stack", "tid", "thread")

    def __init__(self, cap: int, tid: int, thread: str):
        self.buf: list = [None] * cap
        self.cap = cap
        self.n = 0          # total events ever appended
        self.dropped = 0
        self.stack: list[int] = []   # open span ids (parenting)
        self.tid = tid
        self.thread = thread

    def append(self, ev: TraceEvent) -> None:
        if self.n >= self.cap:
            self.dropped += 1
        self.buf[self.n % self.cap] = ev
        self.n += 1

    def events(self) -> list:
        if self.n <= self.cap:
            return self.buf[:self.n]
        i = self.n % self.cap
        return self.buf[i:] + self.buf[:i]


class Tracer:
    """Recording state: per-thread rings + aggregated counters/histograms."""

    # exponential latency buckets (seconds) for histograms
    BUCKETS = (1e-5, 1e-4, 1e-3, 1e-2, 0.1, 1.0, 10.0)

    def __init__(self, capacity: int = 1 << 16):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._lock = threading.Lock()
        # crlint: guarded-by(_lock)
        self._rings: list[_Ring] = []
        self._local = threading.local()
        self._ids = itertools.count(1)
        # crlint: guarded-by(_lock)
        self._counters: dict[str, float] = {}
        # crlint: guarded-by(_lock)
        self._hists: dict[str, list] = {}   # name -> [bucket_counts, sum, n]

    def _ring(self) -> _Ring:
        r = getattr(self._local, "ring", None)
        if r is None:
            t = threading.current_thread()
            r = _Ring(self.capacity, t.ident or 0, t.name)
            self._local.ring = r
            with self._lock:
                self._rings.append(r)
        return r

    def count(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = [[0] * (len(self.BUCKETS) + 1),
                                         0.0, 0]
            for i, edge in enumerate(self.BUCKETS):
                if value <= edge:
                    h[0][i] += 1
                    break
            else:
                h[0][-1] += 1
            h[1] += value
            h[2] += 1

    def events(self) -> list[TraceEvent]:
        """Snapshot of every thread's ring, globally time-ordered."""
        with self._lock:
            rings = list(self._rings)
        out: list[TraceEvent] = []
        for r in rings:
            out.extend(r.events())
        out.sort(key=lambda e: (e.t0, e.t1))
        return out

    def dropped_events(self) -> int:
        with self._lock:
            return sum(r.dropped for r in self._rings)

    def counters(self) -> dict[str, float]:
        with self._lock:
            return dict(self._counters)


# ----------------------------------------------------------- module fast path
_TRACER: Tracer | None = None


def enable(capacity: int = 1 << 16) -> Tracer:
    """Install a fresh process tracer (replacing any prior one)."""
    global _TRACER
    _TRACER = Tracer(capacity)
    return _TRACER


def disable() -> None:
    global _TRACER
    _TRACER = None


def is_enabled() -> bool:
    return _TRACER is not None


def active() -> Tracer | None:
    return _TRACER


class _NoopSpan:
    """Shared do-nothing span: the disabled-mode fast path (no allocation)."""

    __slots__ = ()
    id = 0

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOOP = _NoopSpan()


class _Span:
    """Context-manager span; records on exit into the exiting thread's ring."""

    __slots__ = ("tr", "name", "tier", "nbytes", "parent", "attrs",
                 "t0", "id", "_ring")

    def __init__(self, tr: Tracer, name: str, tier: str, nbytes: int,
                 parent: int | None, attrs: dict | None):
        self.tr = tr
        self.name, self.tier, self.nbytes = name, tier, nbytes
        self.parent, self.attrs = parent, attrs
        self.t0 = 0.0
        self.id = 0
        self._ring: _Ring | None = None

    def __enter__(self) -> "_Span":
        ring = self._ring = self.tr._ring()
        self.id = next(self.tr._ids)
        if self.parent is None:
            self.parent = ring.stack[-1] if ring.stack else 0
        ring.stack.append(self.id)
        self.t0 = clock()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = clock()
        ring = self._ring
        if ring.stack and ring.stack[-1] == self.id:
            ring.stack.pop()
        elif self.id in ring.stack:          # unbalanced exit: repair
            ring.stack.remove(self.id)
        ring.append(TraceEvent("span", self.name, self.tier, self.t0, t1,
                               self.nbytes, self.id, self.parent or 0,
                               ring.tid, ring.thread, self.attrs))
        return False


def span(name: str, tier: str = "host", nbytes: int = 0,
         parent: int | None = None, attrs: dict | None = None):
    """Open a span; ``with trace.span("flush", tier="level0", nbytes=n):``.

    Disabled mode returns the shared no-op singleton (no allocation)."""
    tr = _TRACER
    if tr is None:
        return _NOOP
    return _Span(tr, name, tier, nbytes, parent, attrs)


def complete(name: str, t0: float, t1: float | None = None, *,
             tier: str = "host", nbytes: int = 0,
             parent: int | None = None, attrs: dict | None = None) -> None:
    """Record an already-timed span from explicit ``clock()`` stamps — the
    shape submit→completion pairs take (submit stamps t0, the completion
    reaper emits) and what converted metrics brackets use."""
    tr = _TRACER
    if tr is None:
        return
    ring = tr._ring()
    if parent is None:
        parent = ring.stack[-1] if ring.stack else 0
    ring.append(TraceEvent("span", name, tier, t0,
                           clock() if t1 is None else t1, nbytes,
                           next(tr._ids), parent, ring.tid, ring.thread,
                           attrs))


def event(name: str, *, tier: str = "host", nbytes: int = 0,
          attrs: dict | None = None) -> None:
    """Record an instant event (hedge issue/win, injected fault, retry)."""
    tr = _TRACER
    if tr is None:
        return
    ring = tr._ring()
    now = clock()
    ring.append(TraceEvent("instant", name, tier, now, now, nbytes,
                           next(tr._ids),
                           ring.stack[-1] if ring.stack else 0,
                           ring.tid, ring.thread, attrs))


def count(name: str, value: float = 1.0) -> None:
    tr = _TRACER
    if tr is None:
        return
    tr.count(name, value)


def observe(name: str, value: float) -> None:
    tr = _TRACER
    if tr is None:
        return
    tr.observe(name, value)


def drain() -> list[TraceEvent]:
    """Time-ordered snapshot of all recorded events ([] when disabled)."""
    tr = _TRACER
    return tr.events() if tr is not None else []


def dropped_events() -> int:
    tr = _TRACER
    return tr.dropped_events() if tr is not None else 0


# ------------------------------------------------------------------- exports
def export_perfetto(path: str | None = None,
                    events: list[TraceEvent] | None = None) -> dict:
    """Chrome/Perfetto trace-event JSON: spans as ``X`` events grouped on
    tier-named tracks (pid = tier, tid = recording thread), instants as
    ``i``. Load the written file in ui.perfetto.dev or chrome://tracing.
    Returns the document; writes it to ``path`` when given."""
    evs = drain() if events is None else events
    tiers: dict[str, int] = {}
    te: list[dict] = []
    threads_named: set[tuple[int, int]] = set()
    for e in evs:
        pid = tiers.get(e.tier)
        if pid is None:
            pid = tiers[e.tier] = len(tiers) + 1
            te.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": f"tier:{e.tier}"}})
        if (pid, e.tid) not in threads_named:
            threads_named.add((pid, e.tid))
            te.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": e.tid, "args": {"name": e.thread}})
        args: dict = dict(e.attrs) if e.attrs else {}
        if e.nbytes:
            args["bytes"] = e.nbytes
        if e.parent_id:
            args["parent"] = e.parent_id
        rec = {"name": e.name, "cat": e.tier, "pid": pid, "tid": e.tid,
               "ts": round(e.t0 * 1e6, 3), "args": args}
        if e.kind == "span":
            rec["ph"] = "X"
            rec["dur"] = round(max(e.t1 - e.t0, 0.0) * 1e6, 3)
        else:
            rec["ph"] = "i"
            rec["s"] = "t"
        te.append(rec)
    doc = {"traceEvents": te, "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f)
    return doc


def _prom_name(name: str) -> str:
    return re.sub(r"[^a-zA-Z0-9_]", "_", name)


def export_prometheus(path: str | None = None,
                      events: list[TraceEvent] | None = None) -> str:
    """Prometheus textfile exposition: explicit counters, the dropped-event
    counter, and per-span-name duration/byte histograms derived from the
    recorded spans."""
    tr = _TRACER
    evs = drain() if events is None else events
    lines: list[str] = []
    counters = dict(tr.counters()) if tr is not None else {}
    counters["trace_dropped_events"] = (
        counters.get("trace_dropped_events", 0) + dropped_events())
    for name in sorted(counters):
        m = f"crtrace_{_prom_name(name)}"
        lines.append(f"# TYPE {m} counter")
        lines.append(f"{m} {counters[name]:g}")
    # span duration histograms per (name, tier)
    hists: dict[tuple[str, str], list] = {}
    for e in evs:
        if e.kind != "span":
            continue
        h = hists.setdefault((e.name, e.tier),
                             [[0] * (len(Tracer.BUCKETS) + 1), 0.0, 0])
        d = max(e.t1 - e.t0, 0.0)
        for i, edge in enumerate(Tracer.BUCKETS):
            if d <= edge:
                h[0][i] += 1
                break
        else:
            h[0][-1] += 1
        h[1] += d
        h[2] += 1
    explicit = tr._hists if tr is not None else {}
    with (tr._lock if tr is not None else threading.Lock()):
        for name, h in sorted(explicit.items()):
            hists[(name, "")] = [list(h[0]), h[1], h[2]]
    for (name, tier), (buckets, total, n) in sorted(hists.items()):
        m = f"crtrace_span_seconds_{_prom_name(name)}"
        tag = f'{{tier="{tier}"}}' if tier else ""
        lines.append(f"# TYPE {m} histogram")
        cum = 0
        for i, edge in enumerate(Tracer.BUCKETS):
            cum += buckets[i]
            le = f"{edge:g}"
            if tier:
                lines.append(f'{m}_bucket{{tier="{tier}",le="{le}"}} {cum}')
            else:
                lines.append(f'{m}_bucket{{le="{le}"}} {cum}')
        cum += buckets[-1]
        if tier:
            lines.append(f'{m}_bucket{{tier="{tier}",le="+Inf"}} {cum}')
        else:
            lines.append(f'{m}_bucket{{le="+Inf"}} {cum}')
        lines.append(f"{m}_sum{tag} {total:g}")
        lines.append(f"{m}_count{tag} {n}")
    text = "\n".join(lines) + "\n"
    if path is not None:
        with open(path, "w", encoding="utf-8") as f:
            f.write(text)
    return text


# ----------------------------------------------------------- metrics registry
class MetricsRegistry:
    """One queryable tree over the stack's live Stats objects.

    ``register`` takes an object OR a zero-arg callable resolved at
    ``snapshot()`` time; nothing is copied at registration, so a snapshot
    always reflects the source's CURRENT field values (including computed
    ``@property`` views like ``flush_gbps``). Dataclasses adapt recursively;
    dicts/lists adapt element-wise; everything else passes through."""

    def __init__(self):
        self._sources: dict[str, object] = {}

    def register(self, name: str, source) -> None:
        self._sources[name] = source

    def unregister(self, name: str) -> None:
        self._sources.pop(name, None)

    def names(self) -> list[str]:
        return sorted(self._sources)

    @staticmethod
    def _adapt(obj, depth: int = 0):
        if depth > 6 or obj is None or isinstance(obj, (bool, int, float,
                                                        str)):
            return obj
        if is_dataclass(obj) and not isinstance(obj, type):
            out = {f.name: MetricsRegistry._adapt(getattr(obj, f.name),
                                                  depth + 1)
                   for f in _dc_fields(obj)}
            for k in dir(type(obj)):
                if isinstance(getattr(type(obj), k, None), property):
                    try:
                        out[k] = MetricsRegistry._adapt(getattr(obj, k),
                                                        depth + 1)
                    except Exception as e:
                        out[k] = f"<error: {e!r}>"
            return out
        if isinstance(obj, dict):
            return {str(k): MetricsRegistry._adapt(v, depth + 1)
                    for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return [MetricsRegistry._adapt(v, depth + 1) for v in obj]
        if hasattr(obj, "as_dict"):
            return MetricsRegistry._adapt(obj.as_dict(), depth + 1)
        try:                       # numpy scalars and friends
            return float(obj)
        except (TypeError, ValueError):
            return repr(obj)

    def snapshot(self) -> dict:
        out = {}
        for name, src in self._sources.items():
            obj = src() if callable(src) else src
            out[name] = self._adapt(obj)
        return out

    def query(self, path: str):
        """Dotted lookup into a fresh snapshot: ``query("save.flush_gbps")``."""
        node = self.snapshot()
        for part in path.split("."):
            if not isinstance(node, dict) or part not in node:
                raise KeyError(path)
            node = node[part]
        return node


# --------------------------------------------------------------- stall report
# Wall-time attribution categories for a save/restore root span.
CATEGORIES = ("compute", "d2h", "stage_wait", "level0_write", "level1_flush",
              "remote_put", "remote_get", "barrier")

_D2H_NAMES = {"snapshot", "extract", "gather", "h2d", "d2h"}
_WAIT_NAMES = {"budget.wait", "read.stall", "stage.wait", "acquire.wait"}


def _category(ev: TraceEvent) -> str | None:
    n = ev.name
    if "barrier" in n:
        return "barrier"
    if n in _WAIT_NAMES:
        return "stage_wait"
    if n in _D2H_NAMES:
        return "d2h"
    if ev.tier == "remote":
        return "remote_put" if ("put" in n or "upload" in n) else "remote_get"
    if ev.tier == "level1":
        return "level1_flush"
    if ev.tier == "level0":
        return "level0_write"
    return None           # residual -> compute


@dataclass
class StallReport:
    root: str
    wall: float
    attribution: dict

    @property
    def top(self) -> str:
        return max(self.attribution, key=lambda k: self.attribution[k])

    def render(self) -> str:
        lines = [f"stall report — {self.root}: wall {self.wall * 1e3:.2f} ms"]
        for cat in sorted(self.attribution,
                          key=lambda k: -self.attribution[k]):
            sec = self.attribution[cat]
            pct = 100.0 * sec / self.wall if self.wall else 0.0
            lines.append(f"  {cat:<13} {sec * 1e3:9.2f} ms  {pct:5.1f}%")
        lines.append(f"top bottleneck: {self.top}")
        return "\n".join(lines)


def stall_report(events: list[TraceEvent] | None = None,
                 root: str = "save") -> StallReport | None:
    """Attribute the LAST ``root``-named span's wall time across the stall
    categories by a timeline sweep over the root thread's spans: every
    instant goes to the INNERMOST open span's category (``compute`` when
    none is open), so the categories sum to the wall exactly. Innermost
    handles both proper nesting (the child's interval never double-counts
    into the parent) and overlapping same-thread completions (async engines
    record many in-flight ``io.*`` spans on the reaping thread — a plain
    duration sum would overcount wall several times over). Spans on other
    threads (the overlap the pipeline exists to create) are excluded — see
    the Perfetto export for those."""
    evs = drain() if events is None else events
    roots = [e for e in evs if e.kind == "span" and e.name == root]
    if not roots:
        return None
    rt = roots[-1]
    inner = [e for e in evs
             if e.kind == "span" and e.tid == rt.tid
             and e.span_id != rt.span_id
             and e.t1 > rt.t0 and e.t0 < rt.t1]
    # boundary sweep: +1 at clipped start, -1 at clipped end
    marks: list[tuple[float, int, TraceEvent]] = []
    for e in inner:
        marks.append((max(e.t0, rt.t0), 1, e))
        marks.append((min(e.t1, rt.t1), -1, e))
    marks.sort(key=lambda m: (m[0], -m[1]))
    attribution = {c: 0.0 for c in CATEGORIES}
    open_spans: dict[int, TraceEvent] = {}
    prev = rt.t0
    for t, delta, e in marks:
        if t > prev:
            if open_spans:
                # innermost = the latest-started still-open span
                top = max(open_spans.values(),
                          key=lambda s: (s.t0, s.span_id))
                attribution[_category(top) or "compute"] += t - prev
            else:
                attribution["compute"] += t - prev
            prev = t
        if delta > 0:
            open_spans[e.span_id] = e
        else:
            open_spans.pop(e.span_id, None)
    if rt.t1 > prev:       # tail not covered by any descendant
        attribution["compute"] += rt.t1 - prev
    return StallReport(root=root, wall=rt.t1 - rt.t0,
                       attribution=attribution)
