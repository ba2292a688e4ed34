"""``kccap-torch-sanitize``: runtime lockset race detector + lock-order prover.

The static rules (:mod:`.rules_locks`, :mod:`.rules_lockorder`) prove
what the AST can see; this module catches what it structurally cannot —
ordering bugs.  Three instruments, all env-gated behind
``KCCAP_SANITIZE=1`` and all OFF by construction otherwise (the
identity of ``threading.Lock`` and of every instrumented class's
``__getattribute__``/``__setattr__`` is pinned by test when the gate is
closed):

* **lock wrapping** — :func:`install` replaces ``threading.Lock`` /
  ``RLock`` / ``Condition`` with recording wrappers, so every lock
  *created while installed* feeds a per-thread heldset and a global
  lock-order graph.  A cycle in that graph is a potential deadlock,
  reported with the acquisition sites of both orders.
* **Eraser-style lockset race detection** — classes are instrumented
  with recording ``__getattribute__``/``__setattr__``; the monitored
  fields are the *statically inferred* guarded set from
  :func:`..rules_locks.lock_model`, so the static and dynamic provers
  agree on the instrumented surface by construction (and the hammer
  cross-checks the observation both directions).  Each ``(object,
  field)`` runs the classic virgin → exclusive → shared →
  shared-modified state machine with a candidate lockset refined at
  every access; an empty lockset in shared-modified state is a race,
  reported with both threads' sites and held locks.  Only objects
  *born* under instrumentation are tracked (adoption happens when a
  wrapped lock is assigned to an attribute), so pre-existing globals
  whose raw locks are invisible cannot produce false positives.
* **seeded schedule fuzzing** — a counter-based splitmix64 PRNG makes
  perturbation decision *i* a pure function of ``(seed, i)``: targeted
  pre-acquire yields, occasional micro-sleeps, and
  ``sys.setswitchinterval`` jitter drive the chaos suites through
  diverse interleavings, and the same seed replays the same decision
  sequence.  The seed is printed in every report.

Findings flow through the lint workflow: :class:`~.engine.Finding`
identity, inline ``# kccap: lint-ok[...]`` suppression (a site that
admits ``lock-discipline`` admits ``sanitize-race`` too — they are two
provers of one invariant, and the deliberate racy reads are already
marked), and ``LINT_BASELINE_TORCH.json``.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import _thread
from dataclasses import dataclass

from kubernetesclustercapacity_tpu_torch.analysis.engine import (
    AnalysisResult,
    Baseline,
    Finding,
    parse_suppressions,
)

__all__ = [
    "enabled",
    "install",
    "uninstall",
    "installed",
    "instrument_class",
    "SchedulePRNG",
    "findings",
    "stats",
    "partition",
    "publish_metrics",
    "RACE_RULE",
    "ORDER_RULE",
]

ENV_SWITCH = "KCCAP_SANITIZE"
RACE_RULE = "sanitize-race"
ORDER_RULE = "sanitize-lock-order"

#: Dynamic rule -> static rules whose inline suppression also admits it
#: (one invariant, two provers: a deliberately racy read marked
#: ``lint-ok[lock-discipline]`` is deliberate at runtime too).
RULE_ALIASES = {
    RACE_RULE: ("lock-discipline",),
    ORDER_RULE: ("lock-order",),
}


def enabled() -> bool:
    """The ``KCCAP_SANITIZE=1`` gate — read at install time, never on
    the hot path (when unset, no instrumented code exists at all)."""
    return os.environ.get(ENV_SWITCH, "0").lower() not in ("", "0", "false")


# ---------------------------------------------------------------------------
# Counter-based PRNG: decision i is a pure function of (seed, i).

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


class SchedulePRNG:
    """Counter-based randomness: ``at(i)`` depends only on (seed, i),
    so a replay with the same seed takes the same decisions in the
    same order regardless of which thread asks."""

    def __init__(self, seed: int) -> None:
        self.seed = int(seed) & _MASK64
        self._base = _splitmix64(self.seed ^ 0xA5A5A5A5A5A5A5A5)

    def at(self, i: int) -> int:
        return _splitmix64(self._base ^ (i & _MASK64))


class _ScheduleFuzzer:
    """Seeded schedule perturbation at lock-acquire decision points."""

    SWITCH_CHOICES = (1e-6, 5e-6, 2e-5, 1e-4)

    def __init__(self, seed: int) -> None:
        self.prng = SchedulePRNG(seed)
        self._mu = _thread.allocate_lock()
        self._n = 0
        self.decisions = 0
        self.yields = 0
        self.switch_sets = 0

    def pre_acquire(self) -> None:
        with self._mu:
            i = self._n
            self._n += 1
        r = self.prng.at(i)
        self.decisions += 1
        if r % 16 == 0:
            sys.setswitchinterval(
                self.SWITCH_CHOICES[(r >> 8) % len(self.SWITCH_CHOICES)]
            )
            self.switch_sets += 1
        bucket = (r >> 16) % 8
        if bucket == 0:
            # Targeted pre-acquire yield: hand the GIL to whoever is
            # about to race us for this lock.
            time.sleep(0)
            self.yields += 1
        elif bucket == 1:
            time.sleep(1e-5)
            self.yields += 1


# ---------------------------------------------------------------------------
# Eraser field-state machine.

_FS_VIRGIN, _FS_EXCLUSIVE, _FS_SHARED, _FS_SHARED_MOD = range(4)


@dataclass
class _Access:
    tindex: int  # normalized thread index (T1, T2, ... by first event)
    locks: tuple  # held lock names at the access
    site: tuple  # (abs file, line)
    is_write: bool


@dataclass
class _FieldState:
    state: int = _FS_VIRGIN
    owner: int = -1  # tindex of the exclusive thread
    lockset: frozenset | None = None  # candidate lockset (None = all)
    last: _Access | None = None
    reported: bool = False


@dataclass
class _RaceReport:
    label: str  # "ClassName"
    fld: str
    prev: _Access
    cur: _Access


@dataclass
class _OrderEdge:
    a_name: str
    b_name: str
    a_site: tuple  # where a was acquired by the thread that then took b
    b_site: tuple
    tindex: int


# ---------------------------------------------------------------------------
# Lock wrappers.  Created ONLY while installed; fully functional
# delegates so unrelated code (thread startup Events, torch internals)
# keeps working unperturbed.


class _SanLockBase:
    _kind = "lock"

    def __init__(self, inner, san: "_Sanitizer") -> None:
        self._inner = inner
        self._san = san
        self.seq = san._next_seq()
        self.name: str | None = None

    def _display(self) -> str:
        return self.name or f"anon-{self._kind}#{self.seq}"

    def acquire(self, blocking=True, timeout=-1):
        san = self._san
        if san.active:
            san.pre_acquire(self)
        ok = self._inner.acquire(blocking, timeout)
        if ok and san.active:
            san.on_acquired(self)
        return ok

    def release(self):
        self._inner.release()
        san = self._san
        if san.active:
            san.on_released(self)

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self) -> str:
        return f"<sanitized {self._kind} {self._display()} of {self._inner!r}>"


class _SanLock(_SanLockBase):
    """Wrapped ``threading.Lock``.  No ``_release_save``/``_is_owned``
    on purpose: ``threading.Condition`` then falls back to plain
    ``release()``/``acquire()`` — which are exactly our tracked
    methods."""


class _SanRLock(_SanLockBase):
    _kind = "rlock"

    # Condition support: a Condition built on an RLock uses these to
    # fully release around wait().  The heldset must mirror that.
    def _release_save(self):
        san = self._san
        count = san.held_count(self) if san.active else 0
        state = self._inner._release_save()
        if san.active:
            san.on_release_all(self)
        return (count, state)

    def _acquire_restore(self, saved):
        count, state = saved
        self._inner._acquire_restore(state)
        san = self._san
        if san.active:
            san.on_acquire_restore(self, count)

    def _is_owned(self):
        return self._inner._is_owned()


# ---------------------------------------------------------------------------


class _Sanitizer:
    """All mutable detector state, serialized by one raw mutex."""

    def __init__(self, seed: int, fuzz: bool) -> None:
        self.seed = int(seed)
        self._mu = _thread.allocate_lock()
        self.active = True
        self.fuzzer = _ScheduleFuzzer(seed) if fuzz else None
        self._seq = 0
        # Thread identity via a thread-local index, NOT get_ident():
        # the OS reuses idents after a join, and a reused ident would
        # make two threads look like one (masking a race).
        self._tls = threading.local()
        self._tcount = 0
        self.held: dict[int, list] = {}  # T index -> [lock, ...]
        self.held_sites: dict[int, list] = {}  # parallel acquire sites
        self.fields: dict[tuple, _FieldState] = {}
        self.races: list[_RaceReport] = []
        self.order_edges: dict[tuple, _OrderEdge] = {}  # (seqA, seqB)
        self.locks_by_seq: dict[int, _SanLockBase] = {}
        self.tracked: set[int] = set()  # id(obj) of adopted instances
        self.observed_fields: dict[str, set] = {}  # label -> fields seen
        self.observed_locked_writes: dict[str, set] = {}
        self.instrumented: dict[type, tuple] = {}  # cls -> (label, fields)
        self._patched: list = []  # (cls, attr, had_own, original)
        self.field_events = 0
        self.lock_events = 0

    # -- identity helpers --------------------------------------------------
    def _next_seq(self) -> int:
        with self._mu:
            self._seq += 1
            return self._seq

    def _t(self) -> int:
        """This thread's stable index (1-based, by first event); call
        with ``self._mu`` held."""
        idx = getattr(self._tls, "idx", 0)
        if idx == 0:
            self._tcount += 1
            idx = self._tcount
            self._tls.idx = idx
        return idx

    @staticmethod
    def _caller_site() -> tuple:
        f = sys._getframe(2)
        here = __file__
        while f is not None and f.f_code.co_filename == here:
            f = f.f_back
        if f is None:
            return ("<unknown>", 0)
        return (f.f_code.co_filename, f.f_lineno)

    # -- lock events -------------------------------------------------------
    def pre_acquire(self, lock: _SanLockBase) -> None:
        if self.fuzzer is not None:
            self.fuzzer.pre_acquire()

    def on_acquired(self, lock: _SanLockBase) -> None:
        site = self._caller_site()
        with self._mu:
            self.lock_events += 1
            tindex = self._t()
            held = self.held.setdefault(tindex, [])
            sites = self.held_sites.setdefault(tindex, [])
            if not any(h is lock for h in held):
                for h, h_site in zip(held, sites):
                    if h is lock:
                        continue
                    key = (h.seq, lock.seq)
                    if key not in self.order_edges:
                        self.order_edges[key] = _OrderEdge(
                            h._display(),
                            lock._display(),
                            h_site,
                            site,
                            tindex,
                        )
            held.append(lock)
            sites.append(site)
            self.locks_by_seq.setdefault(lock.seq, lock)

    def on_released(self, lock: _SanLockBase) -> None:
        with self._mu:
            tindex = self._t()
            held = self.held.get(tindex, [])
            sites = self.held_sites.get(tindex, [])
            for i in range(len(held) - 1, -1, -1):
                if held[i] is lock:
                    del held[i]
                    del sites[i]
                    break

    def held_count(self, lock: _SanLockBase) -> int:
        with self._mu:
            tindex = self._t()
            return sum(1 for h in self.held.get(tindex, ()) if h is lock)

    def on_release_all(self, lock: _SanLockBase) -> None:
        with self._mu:
            tindex = self._t()
            held = self.held.get(tindex, [])
            sites = self.held_sites.get(tindex, [])
            keep = [(h, s) for h, s in zip(held, sites) if h is not lock]
            self.held[tindex] = [h for h, _ in keep]
            self.held_sites[tindex] = [s for _, s in keep]

    def on_acquire_restore(self, lock: _SanLockBase, count: int) -> None:
        site = self._caller_site()
        with self._mu:
            tindex = self._t()
            held = self.held.setdefault(tindex, [])
            sites = self.held_sites.setdefault(tindex, [])
            for _ in range(max(count, 1)):
                held.append(lock)
                sites.append(site)

    # -- field events ------------------------------------------------------
    def adopt(self, obj) -> None:
        with self._mu:
            self.tracked.add(id(obj))

    def on_field_access(self, obj, label: str, fld: str, is_write: bool):
        site = self._caller_site()
        with self._mu:
            if id(obj) not in self.tracked:
                return
            self.field_events += 1
            tindex = self._t()
            held = self.held.get(tindex, ())
            lock_names = tuple(
                dict.fromkeys(h._display() for h in held)
            )
            self.observed_fields.setdefault(label, set()).add(fld)
            if is_write and lock_names:
                self.observed_locked_writes.setdefault(label, set()).add(fld)
            access = _Access(tindex, lock_names, site, is_write)
            key = (id(obj), label, fld)
            fs = self.fields.get(key)
            if fs is None:
                fs = _FieldState()
                self.fields[key] = fs
            if fs.state == _FS_VIRGIN:
                fs.state = _FS_EXCLUSIVE
                fs.owner = tindex
            elif fs.state == _FS_EXCLUSIVE:
                if tindex != fs.owner:
                    # Classic Eraser: promote to shared-modified only on
                    # a shared-era WRITE.  (An owner-era write followed
                    # by read-only sharing is the init-handoff pattern —
                    # benign by publication, and exactly the false
                    # positive the original paper documents avoiding.)
                    fs.state = _FS_SHARED_MOD if is_write else _FS_SHARED
                    fs.lockset = frozenset(lock_names)
            else:
                if is_write:
                    fs.state = _FS_SHARED_MOD
                assert fs.lockset is not None
                fs.lockset = fs.lockset & frozenset(lock_names)
            if (
                fs.state == _FS_SHARED_MOD
                and fs.lockset is not None
                and not fs.lockset
                and not fs.reported
            ):
                fs.reported = True
                prev = fs.last or access
                self.races.append(_RaceReport(label, fld, prev, access))
            fs.last = access

    # -- class instrumentation ---------------------------------------------
    def instrument_class(self, cls: type, fields, label: str) -> None:
        if cls in self.instrumented:
            return
        monitored = frozenset(fields)
        self.instrumented[cls] = (label, monitored)
        san = self
        orig_get = cls.__getattribute__
        orig_set = cls.__setattr__

        def __getattribute__(self_, name):
            value = orig_get(self_, name)
            if name in monitored and san.active:
                san.on_field_access(self_, label, name, False)
            return value

        def __setattr__(self_, name, value):
            if san.active:
                if isinstance(value, _SanLockBase):
                    if value.name is None:
                        value.name = f"{label}.{name}"
                    san.adopt(self_)
                if name in monitored:
                    san.on_field_access(self_, label, name, True)
            orig_set(self_, name, value)

        for attr, fn in (
            ("__getattribute__", __getattribute__),
            ("__setattr__", __setattr__),
        ):
            had_own = attr in cls.__dict__
            self._patched.append((cls, attr, had_own, cls.__dict__.get(attr)))
            setattr(cls, attr, fn)

    def unpatch_classes(self) -> None:
        for cls, attr, had_own, original in reversed(self._patched):
            if had_own:
                setattr(cls, attr, original)
            else:
                try:
                    delattr(cls, attr)
                except AttributeError:
                    pass
        self._patched.clear()


# ---------------------------------------------------------------------------
# Install / uninstall: the only code that touches process-global state.

_STATE: _Sanitizer | None = None
_SAVED: dict | None = None


def installed() -> bool:
    return _STATE is not None


def install(*, seed: int = 0, fuzz: bool = True, classes=()) -> None:
    """Arm the sanitizer: patch lock construction, remember the switch
    interval, and instrument ``classes`` (iterable of ``(cls, fields,
    label)``).  Requires ``KCCAP_SANITIZE=1`` — the gate exists so no
    production path can arm instrumentation by accident."""
    global _STATE, _SAVED
    if not enabled():
        raise RuntimeError(
            f"sanitizer is env-gated: set {ENV_SWITCH}=1 to install"
        )
    if _STATE is not None:
        raise RuntimeError("sanitizer already installed (uninstall first)")
    san = _Sanitizer(seed, fuzz)
    saved = {
        "Lock": threading.Lock,
        "RLock": threading.RLock,
        "Condition": threading.Condition,
        "switchinterval": sys.getswitchinterval(),
    }
    orig_lock = threading.Lock
    orig_rlock = threading.RLock
    orig_condition = threading.Condition

    def Lock():
        return _SanLock(orig_lock(), san)

    def RLock():
        return _SanRLock(orig_rlock(), san)

    def Condition(lock=None):
        if lock is None:
            lock = RLock()
        return orig_condition(lock)

    threading.Lock = Lock
    threading.RLock = RLock
    threading.Condition = Condition
    _STATE = san
    _SAVED = saved
    for cls, fields, label in classes:
        san.instrument_class(cls, fields, label)


def instrument_class(cls: type, fields, label: str | None = None) -> None:
    """Monitor ``fields`` on ``cls`` (post-install registration)."""
    if _STATE is None:
        raise RuntimeError("sanitizer is not installed")
    _STATE.instrument_class(cls, fields, label or cls.__name__)


def uninstall() -> None:
    """Restore every patched surface.  Idempotent — safe as a test
    teardown even when nothing was installed.  Wrapped locks created
    during the window keep working afterwards (they delegate to a real
    primitive and their sanitizer is deactivated)."""
    global _STATE, _SAVED
    san, saved = _STATE, _SAVED
    _STATE, _SAVED = None, None
    if san is None:
        return
    san.active = False
    san.unpatch_classes()
    if saved is not None:
        threading.Lock = saved["Lock"]
        threading.RLock = saved["RLock"]
        threading.Condition = saved["Condition"]
        sys.setswitchinterval(saved["switchinterval"])


# ---------------------------------------------------------------------------
# Reporting.


def _rel(path: str, repo_root: str | None) -> str:
    if repo_root:
        try:
            rel = os.path.relpath(path, repo_root)
        except ValueError:
            return path.replace(os.sep, "/")
        if not rel.startswith(".."):
            return rel.replace(os.sep, "/")
    return path.replace(os.sep, "/")


def _fmt_site(site: tuple, repo_root: str | None) -> str:
    return f"{_rel(site[0], repo_root)}:{site[1]}"


def _fmt_locks(locks: tuple) -> str:
    if not locks:
        return "no locks held"
    return "holding {%s}" % ", ".join(f"`{n}`" for n in locks)


def _race_findings(san: _Sanitizer, repo_root: str | None):
    out = []
    seen = set()
    for r in san.races:
        verb_prev = "wrote" if r.prev.is_write else "read"
        verb_cur = "wrote" if r.cur.is_write else "read"
        path = _rel(r.cur.site[0], repo_root)
        line = r.cur.site[1]
        symbol = f"{r.label}.{r.fld}"
        dedup = (symbol, path, line, r.prev.site)
        if dedup in seen:
            continue
        seen.add(dedup)
        out.append(
            Finding(
                rule=RACE_RULE,
                severity="error",
                path=path,
                line=line,
                col=0,
                message=(
                    f"lockset race on `{symbol}`: "
                    f"T{r.prev.tindex} {verb_prev} at "
                    f"{_fmt_site(r.prev.site, repo_root)} "
                    f"({_fmt_locks(r.prev.locks)}); "
                    f"T{r.cur.tindex} {verb_cur} at "
                    f"{_fmt_site(r.cur.site, repo_root)} "
                    f"({_fmt_locks(r.cur.locks)}); candidate lockset is "
                    f"empty [seed {san.seed}]"
                ),
                symbol=symbol,
            )
        )
    return out


def _cycle_findings(san: _Sanitizer, repo_root: str | None):
    # Successor map over lock seqs, then: an edge (a, b) where b
    # reaches a sits on a cycle.
    succ: dict[int, set[int]] = {}
    for a, b in san.order_edges:
        succ.setdefault(a, set()).add(b)
        succ.setdefault(b, set())
    reach_cache: dict[int, set[int]] = {}

    def reach(start: int) -> set[int]:
        hit = reach_cache.get(start)
        if hit is not None:
            return hit
        seen: set[int] = set()
        stack = [start]
        while stack:
            cur = stack.pop()
            for nxt in succ.get(cur, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append(nxt)
        reach_cache[start] = seen
        return seen

    out = []
    for (a, b), edge in sorted(
        san.order_edges.items(),
        key=lambda kv: (kv[1].a_name, kv[1].b_name),
    ):
        if a not in reach(b):
            continue
        opposing = None
        for (x, y), other in san.order_edges.items():
            if x == b and a in reach(y) | {y}:
                opposing = other
                break
        msg = (
            f"lock-order inversion observed: T{edge.tindex} acquired "
            f"`{edge.b_name}` at {_fmt_site(edge.b_site, repo_root)} "
            f"while holding `{edge.a_name}` (taken at "
            f"{_fmt_site(edge.a_site, repo_root)})"
        )
        if opposing is not None:
            msg += (
                f"; the opposing order `{opposing.a_name}` -> "
                f"`{opposing.b_name}` was taken by T{opposing.tindex} at "
                f"{_fmt_site(opposing.b_site, repo_root)}"
            )
        msg += f" [seed {san.seed}]"
        out.append(
            Finding(
                rule=ORDER_RULE,
                severity="error",
                path=_rel(edge.b_site[0], repo_root),
                line=edge.b_site[1],
                col=0,
                message=msg,
                symbol=f"{edge.a_name}->{edge.b_name}",
            )
        )
    return out


def findings(repo_root: str | None = None) -> list:
    """Everything the currently-installed sanitizer observed, as engine
    findings in deterministic order (snapshot via :func:`current` and
    use :func:`findings_of` to report after an uninstall)."""
    san = _STATE
    if san is None:
        raise RuntimeError("sanitizer is not installed")
    return findings_of(san, repo_root)


def findings_of(san: _Sanitizer, repo_root: str | None = None) -> list:
    out = _race_findings(san, repo_root) + _cycle_findings(san, repo_root)
    out.sort(key=lambda f: (f.path, f.line, f.rule, f.symbol, f.message))
    return out


def stats() -> dict:
    """Counters for the CLI/doctor/metrics surfaces."""
    san = _STATE
    if san is None:
        raise RuntimeError("sanitizer is not installed")
    return stats_of(san)


def stats_of(san: _Sanitizer) -> dict:
    fz = san.fuzzer
    return {
        "seed": san.seed,
        "threads_seen": san._tcount,
        "locks_created": san._seq,
        "lock_events": san.lock_events,
        "field_events": san.field_events,
        "order_edges": len(san.order_edges),
        "races": len(san.races),
        "instrumented_classes": len(san.instrumented),
        "schedule_decisions": fz.decisions if fz else 0,
        "schedule_yields": fz.yields if fz else 0,
        "switch_sets": fz.switch_sets if fz else 0,
        "observed_fields": {
            label: sorted(flds)
            for label, flds in sorted(san.observed_fields.items())
        },
        "observed_locked_writes": {
            label: sorted(flds)
            for label, flds in sorted(san.observed_locked_writes.items())
        },
    }


def current() -> _Sanitizer | None:
    """The installed sanitizer (None when the gate is closed) — the
    hammer snapshots it before uninstalling."""
    return _STATE


def partition(
    found: list,
    baseline: Baseline,
    repo_root: str,
) -> AnalysisResult:
    """The lint workflow for dynamic findings: inline ``lint-ok``
    markers at the access site (rule aliases honored) and the shared
    ``LINT_BASELINE_TORCH.json``."""
    sup_cache: dict[str, dict] = {}

    def suppressions_for(path: str) -> dict:
        hit = sup_cache.get(path)
        if hit is None:
            abs_path = os.path.join(repo_root, path)
            try:
                with open(abs_path, encoding="utf-8") as fh:
                    hit = parse_suppressions(fh.read())
            except OSError:
                hit = {}
            sup_cache[path] = hit
        return hit

    live: list = []
    suppressed: list = []
    baselined: list = []
    for f in found:
        admitted = suppressions_for(f.path).get(f.line, ())
        rules = (f.rule,) + RULE_ALIASES.get(f.rule, ())
        if "*" in admitted or any(r in admitted for r in rules):
            suppressed.append(f)
        elif baseline.matches(f):
            baselined.append(f)
        else:
            live.append(f)
    return AnalysisResult(live, suppressed, baselined)


def publish_metrics(st: dict, result: AnalysisResult) -> None:
    """Mirror one sanitize run into the process registry (no-op under
    ``KCCAP_TELEMETRY=0``)."""
    from kubernetesclustercapacity_tpu_torch.telemetry.metrics import (
        REGISTRY,
        enabled as _telemetry_enabled,
    )

    if not _telemetry_enabled():
        return
    REGISTRY.counter(
        "kccap_sanitize_runs_total",
        "Completed sanitizer runs (install → hammer → report).",
    ).inc()
    REGISTRY.counter(
        "kccap_sanitize_races_total",
        "Candidate lockset races observed across sanitizer runs "
        "(suppressed/baselined included — the detector's raw yield).",
    ).inc(st["races"])
    REGISTRY.counter(
        "kccap_sanitize_lock_order_cycles_total",
        "Observed lock-order inversion edges across sanitizer runs.",
    ).inc(sum(1 for f in result.findings + result.suppressed +
              result.baselined if f.rule == ORDER_RULE))
    REGISTRY.gauge(
        "kccap_sanitize_instrumented_classes",
        "Classes under attribute instrumentation in the last run.",
    ).set(st["instrumented_classes"])
    REGISTRY.counter(
        "kccap_sanitize_schedule_decisions_total",
        "Schedule-fuzzer decision points taken (yields + switch-"
        "interval jitter), across runs.",
    ).inc(st["schedule_decisions"])
