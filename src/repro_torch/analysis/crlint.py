"""crlint — durability- and concurrency-invariant static analyzer.

The chaos campaign (core/chaos.py) proves the commit protocol holds at
every *instrumented* site; nothing dynamic can prove a site IS
instrumented.  A new engine or tier that calls ``os.replace`` directly
silently escapes fault injection — the coverage rots without any test
failing.  crlint closes that hole at lint time, the way a sanitizer
complements a fuzzer: the disciplines PRs 4–8 encoded by convention
become machine-checked.

Checkers
--------
CRL001  fault-shim coverage: raw durability calls (``os.replace`` /
        ``rename`` / ``fsync`` / ``fdatasync`` / ``pwrite`` / ``preadv``
        / ``posix_fallocate``, ``shutil.rmtree``) are forbidden in
        ``core/**`` outside ``faults.py``; they must route through the
        ``faults.*`` shims so chaos coverage can never rot.
CRL002  publish ordering: a ``faults.replace`` whose destination matches
        manifest/commit naming (manifest|publish|commit|final|fin) must
        be preceded by an fsync of the source and followed by a
        directory fsync — intra-function, or through a one-level
        call-graph walk (a called function that itself fsyncs counts).
CRL003  guarded-by lock discipline: a field annotated
        ``# crlint: guarded-by(<lock>)`` may only be touched inside a
        ``with self.<lock>:`` block (or in a method annotated
        ``# crlint: holds(<lock>)``); ``__init__`` is exempt (the object
        is not yet shared).
CRL004  resource pairing: a function that acquires staged resources
        (``*pool*.get`` / ``.acquire`` / ``*budget*.add``) must show a
        release path the checker can see — a release-ish call inside a
        ``finally``/``except``, the acquire under a ``with``, or an
        ``abort`` method on the same class that releases (the
        pipeline-stream contract).
CRL005  swallowed injected faults: an ``except`` that could absorb an
        ``InjectedCrash``/``InjectedIOError`` (bare / ``BaseException``
        / ``Exception`` / ``RuntimeError`` without re-raise or
        error-capture; ``OSError`` with ``faults.*`` calls in the try
        body and no preceding Injected* re-raise clause) — the bug
        class PR 6 fixed in ``replace_dir``'s retry loop.
CRL006  clock-epoch discipline: direct ``time.time()`` /
        ``time.perf_counter()`` / ``time.monotonic()`` (and ``_ns``
        variants) in ``core/**`` bypass the tracer's shared monotonic
        epoch — timestamps from different modules stop being
        comparable and spans can't be correlated.  Route timing
        through ``trace.clock()``; genuinely wall-clock sites (pidfile
        epochs, mtime comparisons) annotate ``allow(CRL006)``.
        ``trace.py`` itself (the clock implementation) is exempt.

Annotations (source comments)
-----------------------------
``# crlint: allow(CRL001[, CRL005]): <reason>``   suppress on this line
``# crlint: allow-file(CRL001): <reason>``        suppress module-wide
``# crlint: guarded-by(<lock>[, <lock>])``        on a field assignment
``# crlint: holds(<lock>)``                       on a ``def`` line
``# crlint: fixture``                             treat file as core/**

Baseline
--------
``crlint_baseline.txt`` (repo root) holds accepted pre-existing finding
keys (checker:path:scope:symbol — line numbers are excluded so the
baseline survives unrelated edits); the gate is zero NEW findings.
Regenerate with ``make lint-baseline``; the diff-stat shows reviewers
what was accepted.

CRL002's one-level walk resolves callees by name, so a call like
``m.save(...)`` is credited with an fsync if ANY analyzed function named
``save`` fsyncs directly — deliberately permissive (no false positives
on dynamic dispatch) at the cost of missing some violations; CRL001
independently guarantees new sites stay shim-routed.
"""

from __future__ import annotations

import argparse
import ast
import os
import re
import sys
from collections import Counter
from dataclasses import dataclass, field

CHECKERS = {
    "CRL001": "fault-shim coverage (raw durability syscall in core)",
    "CRL002": "publish ordering (fsync -> rename -> dir fsync)",
    "CRL003": "guarded-by lock discipline",
    "CRL004": "resource acquire/release pairing",
    "CRL005": "except clause can swallow injected faults",
    "CRL006": "un-epoched clock call (use trace.clock)",
}

DEFAULT_BASELINE = "crlint_baseline.txt"

# raw call -> the shim that must be used instead
RAW_SHIMS = {
    "os.replace": "faults.replace",
    "os.rename": "faults.replace",
    "os.fsync": "faults.fsync",
    "os.fdatasync": "faults.fdatasync",
    "os.pwrite": "faults.pwrite",
    "os.preadv": "faults.preadv",
    "os.posix_fallocate": "faults.posix_fallocate",
    "shutil.rmtree": "faults.rmtree",
}

# clock calls that fragment the shared trace epoch (CRL006)
CLOCK_CALLS = {"time.time", "time.time_ns", "time.perf_counter",
               "time.perf_counter_ns", "time.monotonic",
               "time.monotonic_ns"}

FSYNC_CALLS = ("faults.fsync", "faults.fdatasync")
PUBLISH_DST_RE = re.compile(r"manifest|publish|commit|final|\bfin\b", re.I)

BROAD_EXCEPTS = {"<bare>", "BaseException", "Exception", "RuntimeError",
                 "InjectedCrash", "InjectedIOError"}
OSERROR_EXCEPTS = {"OSError", "IOError", "EnvironmentError"}
INJECTED_NAMES = {"InjectedCrash", "InjectedIOError"}

ACQUIRE_RELEASE = {"release", "destroy", "put", "settle", "sub", "abort",
                   "close", "drain", "_forget"}

_DIRECTIVE_RE = re.compile(r"#\s*crlint:\s*(.+?)\s*$")
_ALLOW_RE = re.compile(r"allow\(([^)]*)\)")
_ALLOW_FILE_RE = re.compile(r"allow-file\(([^)]*)\)")
_GUARDED_RE = re.compile(r"guarded-by\(([^)]*)\)")
_HOLDS_RE = re.compile(r"holds\(([^)]*)\)")


@dataclass
class Finding:
    checker: str
    path: str          # repo-relative, forward slashes
    line: int
    scope: str         # Class.method | function | <module>
    symbol: str        # what the finding is about (stable across edits)
    message: str

    def key(self) -> str:
        """Baseline key — excludes the line number so the suppression
        survives edits elsewhere in the file."""
        return f"{self.checker}:{self.path}:{self.scope}:{self.symbol}"

    def render(self) -> str:
        return (f"{self.path}:{self.line}: {self.checker} "
                f"[{self.scope}] {self.message}")


def _dotted(node: ast.AST) -> str | None:
    """'os.replace', 'self.pool.get', 'replace_dir', ... (None: dynamic)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base is not None else None
    return None


def _csv(text: str) -> list[str]:
    return [t.strip() for t in text.split(",") if t.strip()]


@dataclass
class Unit:
    """One analyzable function/method, nested defs flattened in."""
    qualname: str
    name: str                       # bare name
    cls: str | None
    node: ast.AST
    calls: list[tuple[int, int, str]] = field(default_factory=list)
    has_direct_fsync: bool = False


class Module:
    def __init__(self, path: str, rel: str, source: str, tree: ast.Module):
        self.path = path
        self.rel = rel
        self.source = source
        self.tree = tree
        self.lines = source.splitlines()
        self.allow_lines: dict[int, set[str]] = {}
        self.file_allows: set[str] = set()
        self.holds_lines: dict[int, set[str]] = {}
        self.guard_lines: dict[int, set[str]] = {}
        self.is_fixture = False
        self._parse_directives()
        parts = rel.replace(os.sep, "/").split("/")
        self.is_core = "core" in parts or self.is_fixture
        self.is_faults = os.path.basename(rel) == "faults.py"
        self.is_trace = os.path.basename(rel) == "trace.py"
        self.units: list[Unit] = []
        self.scope_of: dict[int, str] = {}   # id(node) -> qualname
        self._collect_units()
        self.raw_aliases = self._raw_import_aliases()

    # ------------------------------------------------------------ directives
    def _parse_directives(self) -> None:
        for i, raw in enumerate(self.lines, start=1):
            m = _DIRECTIVE_RE.search(raw)
            if not m:
                continue
            body = m.group(1)
            code_before = raw[:m.start()].strip()
            targets = [i] if code_before else [i, i + 1]
            if body.strip() == "fixture":
                self.is_fixture = True
                continue
            fa = _ALLOW_FILE_RE.search(body)
            if fa:
                self.file_allows.update(_csv(fa.group(1)))
                continue
            a = _ALLOW_RE.search(body)
            if a:
                for t in targets:
                    self.allow_lines.setdefault(t, set()).update(
                        _csv(a.group(1)))
            h = _HOLDS_RE.search(body)
            if h:
                for t in targets:
                    self.holds_lines.setdefault(t, set()).update(
                        _csv(h.group(1)))
            g = _GUARDED_RE.search(body)
            if g:
                for t in targets:
                    self.guard_lines.setdefault(t, set()).update(
                        _csv(g.group(1)))

    def allowed(self, checker: str, node: ast.AST) -> bool:
        if checker in self.file_allows:
            return True
        first = getattr(node, "lineno", 0)
        last = getattr(node, "end_lineno", first) or first
        for ln in range(first - 1, last + 1):
            if checker in self.allow_lines.get(ln, ()):
                return True
        return False

    # ----------------------------------------------------------------- units
    def _collect_units(self) -> None:
        def add(node, cls):
            qual = f"{cls}.{node.name}" if cls else node.name
            u = Unit(qual, node.name, cls, node)
            for n in ast.walk(node):
                if isinstance(n, ast.Call):
                    d = _dotted(n.func)
                    if d is None:
                        continue
                    u.calls.append((n.lineno, n.col_offset, d))
                    if d in FSYNC_CALLS:
                        u.has_direct_fsync = True
            u.calls.sort()
            for n in ast.walk(node):
                self.scope_of.setdefault(id(n), qual)
            self.units.append(u)

        for stmt in self.tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                add(stmt, None)
            elif isinstance(stmt, ast.ClassDef):
                for sub in stmt.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        add(sub, stmt.name)

    def scope(self, node: ast.AST) -> str:
        return self.scope_of.get(id(node), "<module>")

    def _raw_import_aliases(self) -> dict[str, str]:
        """`from os import replace as rp` -> {'rp': 'os.replace'}."""
        out: dict[str, str] = {}
        for n in ast.walk(self.tree):
            if isinstance(n, ast.ImportFrom) and n.module == "time":
                for a in n.names:
                    full = f"time.{a.name}"
                    if full in CLOCK_CALLS:
                        out[a.asname or a.name] = full
            if isinstance(n, ast.ImportFrom) and n.module in ("os", "shutil"):
                for a in n.names:
                    full = f"{n.module}.{a.name}"
                    if full in RAW_SHIMS:
                        out[a.asname or a.name] = full
        return out


# =========================================================== CRL001 coverage
def check_shim_coverage(mod: Module) -> list[Finding]:
    if not mod.is_core or mod.is_faults:
        return []
    out = []
    for n in ast.walk(mod.tree):
        if not isinstance(n, ast.Call):
            continue
        d = _dotted(n.func)
        if d is None:
            continue
        raw = d if d in RAW_SHIMS else mod.raw_aliases.get(d)
        if raw not in RAW_SHIMS:
            continue
        if mod.allowed("CRL001", n):
            continue
        out.append(Finding(
            "CRL001", mod.rel, n.lineno, mod.scope(n), raw,
            f"raw {raw} escapes chaos injection; route through "
            f"{RAW_SHIMS[raw]}"))
    return out


# ====================================================== CRL002 publish order
def _fsync_units(modules: list[Module]) -> set[str]:
    """Bare names of units that call faults.fsync/fdatasync directly."""
    return {u.name for m in modules for u in m.units if u.has_direct_fsync}


def check_publish_ordering(mod: Module, fsync_names: set[str]
                           ) -> list[Finding]:
    if not mod.is_core:
        return []
    out = []
    for u in mod.units:
        events = []   # (line, col, kind) with kind in {"fsync", node}
        for line, col, d in u.calls:
            if d in FSYNC_CALLS:
                events.append((line, col, "fsync"))
            elif d.rsplit(".", 1)[-1] in fsync_names and not \
                    d.startswith(("os.", "shutil.")):
                # one-level walk: callee (resolved by name) fsyncs itself
                events.append((line, col, "fsync"))
        replaces = []
        for n in ast.walk(u.node):
            if (isinstance(n, ast.Call) and _dotted(n.func) == "faults.replace"
                    and len(n.args) >= 2):
                dst_src = ast.get_source_segment(mod.source, n.args[1]) or ""
                if PUBLISH_DST_RE.search(dst_src):
                    replaces.append((n, dst_src))
        for n, dst_src in replaces:
            if mod.allowed("CRL002", n):
                continue
            pos = (n.lineno, n.col_offset)
            before = any(e[:2] < pos for e in events)
            after = any(e[:2] > pos for e in events)
            if not before:
                out.append(Finding(
                    "CRL002", mod.rel, n.lineno, u.qualname,
                    "replace-unsynced-src",
                    f"publish rename to {dst_src!r} without a visible fsync "
                    f"of the source before it"))
            if not after:
                out.append(Finding(
                    "CRL002", mod.rel, n.lineno, u.qualname,
                    "replace-no-dirsync",
                    f"publish rename to {dst_src!r} without a directory "
                    f"fsync after it (rename is not durable until the "
                    f"parent dir is synced)"))
    return out


# ======================================================== CRL003 guarded-by
def _with_locks(node: ast.With) -> set[str]:
    got = set()
    for item in node.items:
        d = _dotted(item.context_expr)
        if d is not None and d.startswith("self."):
            got.add(d[len("self."):])
    return got


class _GuardVisitor(ast.NodeVisitor):
    def __init__(self, mod: Module, qualname: str,
                 guards: dict[str, set[str]], held: set[str]):
        self.mod = mod
        self.qualname = qualname
        self.guards = guards
        self.held = set(held)
        self.findings: list[Finding] = []
        self.seen: set[str] = set()     # fields already reported here

    def visit_With(self, node: ast.With) -> None:
        for item in node.items:
            self.visit(item.context_expr)
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
        saved = set(self.held)
        self.held |= _with_locks(node)
        for stmt in node.body:
            self.visit(stmt)
        self.held = saved

    visit_AsyncWith = visit_With

    def visit_FunctionDef(self, node) -> None:
        # a nested def runs later: locks held at the def site are NOT held
        # at the call site (unless the def line carries # crlint: holds())
        saved = set(self.held)
        self.held = set(self.mod.holds_lines.get(node.lineno, ()))
        for stmt in node.body:
            self.visit(stmt)
        self.held = saved

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if (isinstance(node.value, ast.Name) and node.value.id == "self"
                and node.attr in self.guards
                and node.attr not in self.seen
                and not self.held & self.guards[node.attr]
                and not self.mod.allowed("CRL003", node)):
            locks = " or ".join(
                f"self.{a}" for a in sorted(self.guards[node.attr]))
            self.seen.add(node.attr)
            self.findings.append(Finding(
                "CRL003", self.mod.rel, node.lineno, self.qualname,
                node.attr,
                f"self.{node.attr} accessed without holding {locks} "
                f"(guarded-by)"))
        self.generic_visit(node)


def check_guarded_by(mod: Module) -> list[Finding]:
    out = []
    for stmt in mod.tree.body:
        if not isinstance(stmt, ast.ClassDef):
            continue
        guards: dict[str, set[str]] = {}
        methods = [n for n in stmt.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for meth in methods:
            for n in ast.walk(meth):
                if not isinstance(n, (ast.Assign, ast.AnnAssign,
                                      ast.AugAssign)):
                    continue
                locks: set[str] = set()
                last = getattr(n, "end_lineno", n.lineno) or n.lineno
                for ln in range(n.lineno, last + 1):
                    locks |= mod.guard_lines.get(ln, set())
                if not locks:
                    continue
                targets = (n.targets if isinstance(n, ast.Assign)
                           else [n.target])
                for t in targets:
                    if (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"):
                        guards.setdefault(t.attr, set()).update(locks)
        if not guards:
            continue
        for meth in methods:
            if meth.name == "__init__":   # not yet shared between threads
                continue
            held = set(mod.holds_lines.get(meth.lineno, ()))
            v = _GuardVisitor(mod, f"{stmt.name}.{meth.name}", guards, held)
            for sub in meth.body:
                v.visit(sub)
            out.extend(v.findings)
    return out


# ================================================== CRL004 resource pairing
def _is_acquire(dotted: str) -> bool:
    if "lock" in dotted.lower() or "cond" in dotted.lower():
        return False
    leaf = dotted.rsplit(".", 1)[-1]
    if leaf == "acquire" and "." in dotted:
        return True
    if leaf == "get" and "pool" in dotted.lower():
        return True
    if leaf == "add" and "budget" in dotted.lower():
        return True
    return False


def _release_calls(node: ast.AST):
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            d = _dotted(n.func)
            if d and "." in d and d.rsplit(".", 1)[-1] in ACQUIRE_RELEASE:
                yield n


def check_resource_pairing(mod: Module) -> list[Finding]:
    if not mod.is_core:
        return []
    # classes with an abort() that releases: the pipeline-stream contract
    # (the caller guarantees `except BaseException: stream.abort(); raise`)
    abort_classes = {
        u.cls for u in mod.units
        if u.cls and u.name == "abort" and any(_release_calls(u.node))}
    out = []
    for u in mod.units:
        acquires = [n for n in ast.walk(u.node)
                    if isinstance(n, ast.Call)
                    and _dotted(n.func) is not None
                    and _is_acquire(_dotted(n.func))]
        if not acquires:
            continue
        if u.cls in abort_classes:
            continue
        cleanup_release = False
        for n in ast.walk(u.node):
            if isinstance(n, ast.Try):
                for blk in ([n.finalbody]
                            + [h.body for h in n.handlers]):
                    for stmt in blk:
                        if any(_release_calls(stmt)):
                            cleanup_release = True
        if cleanup_release:
            continue
        managed_spans = [
            (w.lineno, w.end_lineno or w.lineno)
            for w in ast.walk(u.node) if isinstance(w, ast.With)]
        unmanaged = [
            n for n in acquires
            if not any(a <= n.lineno <= b for a, b in managed_spans)]
        if not unmanaged:
            continue
        first = min(unmanaged, key=lambda n: (n.lineno, n.col_offset))
        if mod.allowed("CRL004", first):
            continue
        what = _dotted(first.func)
        out.append(Finding(
            "CRL004", mod.rel, first.lineno, u.qualname, "acquire-no-release",
            f"{what}(...) has no release path on error (want a release/"
            f"settle in finally/except, a with-block, or an abort() on "
            f"the class)"))
    return out


# ================================================= CRL006 clock discipline
def check_clock_epoch(mod: Module) -> list[Finding]:
    """Direct stdlib clock reads in core/** fragment the tracer's shared
    monotonic epoch (trace.clock()); wall-clock sites must say so."""
    if not mod.is_core or mod.is_trace:
        return []
    out = []
    for n in ast.walk(mod.tree):
        if not isinstance(n, ast.Call):
            continue
        d = _dotted(n.func)
        if d is None:
            continue
        raw = d if d in CLOCK_CALLS else mod.raw_aliases.get(d)
        if raw not in CLOCK_CALLS:
            continue
        if mod.allowed("CRL006", n):
            continue
        out.append(Finding(
            "CRL006", mod.rel, n.lineno, mod.scope(n), raw,
            f"{raw}() bypasses the shared trace epoch; use trace.clock() "
            f"(or annotate allow(CRL006) for a true wall-clock site)"))
    return out


# ============================================== CRL005 swallowed injections
def _caught_names(handler: ast.ExceptHandler) -> set[str]:
    t = handler.type
    if t is None:
        return {"<bare>"}
    nodes = t.elts if isinstance(t, ast.Tuple) else [t]
    names = set()
    for n in nodes:
        if isinstance(n, ast.Name):
            names.add(n.id)
        elif isinstance(n, ast.Attribute):
            names.add(n.attr)
    return names


def check_swallowed_faults(mod: Module) -> list[Finding]:
    if not mod.is_core or mod.is_faults:
        return []
    out = []
    for t in ast.walk(mod.tree):
        if not isinstance(t, ast.Try):
            continue
        try_faults = any(
            isinstance(n, ast.Call) and (_dotted(n.func) or "").startswith(
                "faults.")
            for stmt in t.body for n in ast.walk(stmt))
        injected_guarded = False
        for h in t.handlers:
            caught = _caught_names(h)
            has_raise = any(isinstance(n, ast.Raise) for n in ast.walk(h))
            if caught & INJECTED_NAMES and has_raise:
                injected_guarded = True
                continue
            captures = h.name is not None and any(
                isinstance(n, ast.Name) and n.id == h.name
                and isinstance(n.ctx, ast.Load)
                for stmt in h.body for n in ast.walk(stmt))
            if caught & BROAD_EXCEPTS and not has_raise and not captures:
                if not mod.allowed("CRL005", h):
                    shown = ", ".join(sorted(caught & BROAD_EXCEPTS))
                    out.append(Finding(
                        "CRL005", mod.rel, h.lineno, mod.scope(h),
                        "except-broad",
                        f"except {shown} neither re-raises nor captures "
                        f"the error: an InjectedCrash unwinding here is "
                        f"silently absorbed"))
            elif (caught & OSERROR_EXCEPTS and try_faults
                    and not has_raise and not injected_guarded):
                if not mod.allowed("CRL005", h):
                    out.append(Finding(
                        "CRL005", mod.rel, h.lineno, mod.scope(h),
                        "except-oserror-near-faults",
                        "except OSError around faults.* calls absorbs "
                        "injected errnos (the PR-6 replace_dir bug class); "
                        "re-raise Injected* first"))
    return out


# ================================================================== driver
def _iter_py(paths: list[str]) -> list[str]:
    files = []
    for p in paths:
        if os.path.isfile(p):
            files.append(p)
            continue
        for root, dirs, names in os.walk(p):
            dirs[:] = sorted(d for d in dirs if d != "__pycache__")
            files.extend(os.path.join(root, n) for n in sorted(names)
                         if n.endswith(".py"))
    return sorted(set(files))


def _load_modules(files: list[str]) -> tuple[list[Module], list[Finding]]:
    mods, errs = [], []
    for f in files:
        rel = os.path.relpath(f).replace(os.sep, "/")
        with open(f, "r", encoding="utf-8") as fh:
            src = fh.read()
        try:
            tree = ast.parse(src, filename=f)
        except SyntaxError as e:
            errs.append(Finding("CRL000", rel, e.lineno or 0, "<module>",
                                "syntax-error", f"cannot parse: {e.msg}"))
            continue
        mods.append(Module(f, rel, src, tree))
    return mods, errs


def analyze_paths(paths: list[str]) -> list[Finding]:
    """Run every checker over the .py files under ``paths`` (inline
    ``allow``/``allow-file`` annotations already applied)."""
    mods, findings = _load_modules(_iter_py(paths))
    fsync_names = _fsync_units(mods)
    for m in mods:
        findings += check_shim_coverage(m)
        findings += check_publish_ordering(m, fsync_names)
        findings += check_guarded_by(m)
        findings += check_resource_pairing(m)
        findings += check_swallowed_faults(m)
        findings += check_clock_epoch(m)
    findings.sort(key=lambda f: (f.path, f.line, f.checker, f.symbol))
    return findings


def load_baseline(path: str) -> Counter:
    counts: Counter = Counter()
    if not os.path.exists(path):
        return counts
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line and not line.startswith("#"):
                counts[line] += 1
    return counts


def write_baseline(findings: list[Finding], path: str) -> tuple[int, int]:
    """Write the suppression file; returns (added, removed) vs the old."""
    old = load_baseline(path)
    new = Counter(f.key() for f in findings)
    added = sum((new - old).values())
    removed = sum((old - new).values())
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("# crlint accepted pre-existing findings — one key per "
                 "line (checker:path:scope:symbol).\n"
                 "# Regenerate with `make lint-baseline`; review the "
                 "diff-stat before committing.\n")
        for key in sorted(new.elements()):
            fh.write(key + "\n")
    return added, removed


def apply_baseline(findings: list[Finding], baseline: Counter
                   ) -> tuple[list[Finding], int]:
    remaining = Counter(baseline)
    fresh = []
    suppressed = 0
    for f in findings:
        if remaining[f.key()] > 0:
            remaining[f.key()] -= 1
            suppressed += 1
        else:
            fresh.append(f)
    return fresh, suppressed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="crlint",
        description="durability/concurrency invariant linter "
                    "(see DESIGN.md §16)")
    ap.add_argument("paths", nargs="*", default=["src/repro"],
                    help="files or directories to analyze")
    ap.add_argument("--baseline", default=None,
                    help=f"suppression file (default: {DEFAULT_BASELINE} "
                         f"when present)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignoring the baseline")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept current findings into the baseline and "
                         "print a diff-stat")
    args = ap.parse_args(argv)

    findings = analyze_paths(args.paths)
    bl_path = args.baseline or DEFAULT_BASELINE

    if args.write_baseline:
        added, removed = write_baseline(findings, bl_path)
        print(f"crlint: baseline {bl_path}: {len(findings)} accepted "
              f"finding(s) (+{added} / -{removed})")
        for f in findings:
            print("  " + f.render())
        return 0

    baseline = Counter() if args.no_baseline else load_baseline(bl_path)
    fresh, suppressed = apply_baseline(findings, baseline)
    for f in fresh:
        print(f.render())
    stale = sum((baseline - Counter(f.key() for f in findings)).values())
    tail = f", {stale} baseline entr{'y' if stale == 1 else 'ies'} stale" \
        if stale else ""
    print(f"crlint: {len(fresh)} new finding(s), "
          f"{suppressed} baselined{tail}")
    return 1 if fresh else 0


if __name__ == "__main__":
    sys.exit(main())
