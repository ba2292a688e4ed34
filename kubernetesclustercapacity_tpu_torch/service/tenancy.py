"""First-class multi-tenancy: the tenant map and the weighted-fair queue.

Counterpart of ``kubernetesclustercapacity_tpu/service/tenancy.py``
(verbatim apart from imports).

Two pieces, both consumed by :class:`~.plane.AdmissionController` and
:class:`~.server.CapacityServer`:

* :class:`TenantMap` — the ``-tenants FILE`` grammar: named tenants,
  each with an optional bearer token (requests presenting it are
  attributed to that tenant — the handshake stays byte-compatible, the
  token rides the existing ``token``/``tenant_token`` fields), an
  optional per-tenant rps cap + burst, an optional per-tenant
  concurrency quota, and a fair-share ``weight``.  Token lookup goes
  through a SHA-256 index so attribution is hash-equality, never a
  data-dependent scan over secrets.
* :class:`FairSlotQueue` — a deficit-round-robin (DRR) concurrency
  gate: N slots shared across per-tenant sub-queues.  Each released
  slot is granted to the tenant sub-queue whose deficit counter has
  banked enough credit; every queued tenant gains ``quantum * weight``
  credit per rotation, so no tenant can starve another — a hot tenant
  with a thousand queued requests advances exactly as fast as its
  weight entitles it, and an idle tenant's first request waits at most
  one rotation.  The starvation bound is pinned by tests and the
  sanitize hammer drives the class under adversarial schedules.

Tenancy as a whole is gated by ``KCCAP_TENANCY`` (unset/``1`` = armed
when a map is given; ``0`` = the exact pre-tenancy single-queue
admission path, map or not).
"""

from __future__ import annotations

import collections
import hashlib
import json
import os
import threading
from dataclasses import dataclass

__all__ = [
    "TenancyError",
    "TenantSpec",
    "TenantMap",
    "FairSlotQueue",
    "FoldAccounting",
    "parse_tenants",
    "load_tenants",
    "enabled",
]

#: Metric-label-safe tenant names (also keeps the map greppable).
_NAME_OK = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789._-"
)

_TENANT_KEYS = frozenset(
    {"name", "token", "rps", "burst", "max_concurrent", "weight"}
)


def enabled() -> bool:
    """The ``KCCAP_TENANCY`` gate: ``0`` disables tenancy everywhere
    (the exact pre-tenancy admission path), anything else arms it when
    a tenant map is configured."""
    return os.environ.get("KCCAP_TENANCY", "1") != "0"


class TenancyError(ValueError):
    """Malformed tenant map (bad grammar, bad numbers, dupes)."""


@dataclass(frozen=True)
class TenantSpec:
    """One tenant: identity plus its quota envelope."""

    name: str
    token: str | None = None  # bearer token attributing requests to us
    rps: float = 0.0  # per-tenant token-bucket cap (0 = uncapped)
    burst: float | None = None  # bucket capacity (None = max(rps, 1))
    max_concurrent: int = 0  # per-tenant in-flight quota (0 = uncapped)
    weight: float = 1.0  # DRR fair-share weight

    def to_wire(self) -> dict:
        """The info/doctor rendering — the token NEVER rides it."""
        return {
            "name": self.name,
            "rps": self.rps,
            "max_concurrent": self.max_concurrent,
            "weight": self.weight,
        }


def _token_key(token: str) -> str:
    return hashlib.sha256(token.encode()).hexdigest()


def _parse_tenant(i: int, entry) -> TenantSpec:
    if not isinstance(entry, dict):
        raise TenancyError(f"tenant #{i}: expected a mapping, got {entry!r}")
    name = entry.get("name")
    if not isinstance(name, str) or not name:
        raise TenancyError(f"tenant #{i}: 'name' must be a non-empty string")
    if not set(name) <= _NAME_OK:
        raise TenancyError(
            f"tenant {name!r}: names are metric labels — stick to "
            "[A-Za-z0-9._-]"
        )
    unknown = set(entry) - _TENANT_KEYS
    if unknown:
        raise TenancyError(
            f"tenant {name!r}: unknown field(s) {sorted(unknown)} "
            f"(want a subset of {sorted(_TENANT_KEYS)})"
        )
    token = entry.get("token")
    if token is not None and (not isinstance(token, str) or not token):
        raise TenancyError(
            f"tenant {name!r}: 'token' must be a non-empty string"
        )
    rps = entry.get("rps", 0.0)
    if isinstance(rps, bool) or not isinstance(rps, (int, float)) or rps < 0:
        raise TenancyError(f"tenant {name!r}: rps must be a number >= 0")
    burst = entry.get("burst")
    if burst is not None and (
        isinstance(burst, bool)
        or not isinstance(burst, (int, float))
        or burst < 1
    ):
        raise TenancyError(f"tenant {name!r}: burst must be a number >= 1")
    max_concurrent = entry.get("max_concurrent", 0)
    if (
        isinstance(max_concurrent, bool)
        or not isinstance(max_concurrent, int)
        or max_concurrent < 0
    ):
        raise TenancyError(
            f"tenant {name!r}: max_concurrent must be an int >= 0"
        )
    weight = entry.get("weight", 1.0)
    if (
        isinstance(weight, bool)
        or not isinstance(weight, (int, float))
        or weight <= 0
    ):
        raise TenancyError(f"tenant {name!r}: weight must be a number > 0")
    return TenantSpec(
        name=name,
        token=token,
        rps=float(rps),
        burst=None if burst is None else float(burst),
        max_concurrent=int(max_concurrent),
        weight=float(weight),
    )


class TenantMap:
    """The parsed ``-tenants FILE``: immutable after construction, so
    every reader (admission gates, the server's attribution seam,
    metric-label folding) shares it lock-free."""

    def __init__(self, specs) -> None:
        self.specs = tuple(specs)
        self._by_name = {s.name: s for s in self.specs}
        if len(self._by_name) != len(self.specs):
            names = [s.name for s in self.specs]
            dupes = sorted({n for n in names if names.count(n) > 1})
            raise TenancyError(f"duplicate tenant name(s): {dupes}")
        self._token_index: dict[str, str] = {}
        for s in self.specs:
            if s.token is None:
                continue
            key = _token_key(s.token)
            if key in self._token_index:
                raise TenancyError(
                    f"tenant {s.name!r} reuses another tenant's token"
                )
            self._token_index[key] = s.name

    def __len__(self) -> int:
        return len(self.specs)

    def __contains__(self, name) -> bool:
        return name in self._by_name

    @property
    def names(self) -> tuple:
        return tuple(s.name for s in self.specs)

    def spec(self, name: str) -> TenantSpec | None:
        return self._by_name.get(name)

    def tenant_of(self, token) -> str | None:
        """Token → tenant name (``None`` when the token names nobody).
        Comparison happens on SHA-256 digests, so attribution is a hash
        lookup — never a data-dependent walk over stored secrets."""
        if not isinstance(token, str) or not token:
            return None
        return self._token_index.get(_token_key(token))

    def weight(self, name: str) -> float:
        """DRR weight for the tenant (unmapped tenants weigh 1.0)."""
        spec = self._by_name.get(name)
        return spec.weight if spec is not None else 1.0

    def label(self, tenant: str) -> str:
        """The bounded-cardinality metric label: map-named tenants (and
        the ``default`` fallback identity) keep their name; everything
        else folds to ``other`` so a tenant-id flood can never explode
        a label set."""
        if tenant == "default" or tenant in self._by_name:
            return tenant
        return "other"

    def to_wire(self) -> dict:
        return {
            "tenants": [s.to_wire() for s in self.specs],
        }


class FoldAccounting:
    """Cross-tenant fold attribution: who shared whose kernel launch.

    The micro-batcher's fold queue coalesces concurrent requests across
    tenants into one padded dispatch (bit-exact vs solo — the combined
    dispatch is index-scattered and never reads the label), which makes
    "whose work rode that launch" invisible to the per-tenant admission
    metrics.  This is the batcher's ``fold_hook``: called once per
    MULTI-request dispatch with the members' tenant identities, it
    counts each member on ``kccap_tenant_folded_requests_total`` under
    its bounded :meth:`TenantMap.label` (so a tenant-id flood cannot
    explode the label set) and bumps ``kccap_fold_cross_tenant_total``
    when the fold actually crossed a tenant boundary — the number the
    multi-tenant amortization claim rests on.  Pure attribution: it
    influences nothing and must never fail a dispatch (the batcher
    swallows exceptions, and this class raises none by construction).
    """

    def __init__(self, tenant_map: TenantMap | None, registry) -> None:
        self._map = tenant_map
        self._folded = registry.counter(
            "kccap_tenant_folded_requests_total",
            "Requests served as members of a multi-request folded "
            "dispatch, by (bounded) tenant label.",
            ("tenant",),
        )
        self._cross = registry.counter(
            "kccap_fold_cross_tenant_total",
            "Folded dispatches whose members spanned more than one "
            "tenant (one padded launch shared across tenant "
            "boundaries).",
        )

    def _label(self, tenant) -> str:
        if not isinstance(tenant, str) or not tenant:
            return "other"  # anonymous member (tenancy off for it)
        if self._map is None:
            return "other"
        return self._map.label(tenant)

    def __call__(self, tenants) -> None:
        labels = [self._label(t) for t in tenants]
        for lab in labels:
            self._folded.labels(tenant=lab).inc()
        if len(set(labels)) > 1:
            self._cross.inc()


def parse_tenants(data) -> TenantMap:
    """Parsed document (``{"tenants": [...]}`` or a bare list) → map."""
    if isinstance(data, dict):
        entries = data.get("tenants")
        extra = set(data) - {"tenants"}
        if extra:
            raise TenancyError(
                f"unknown top-level field(s) {sorted(extra)}"
            )
    else:
        entries = data
    if not isinstance(entries, list) or not entries:
        raise TenancyError(
            "tenant file wants a non-empty 'tenants' list (or a bare list)"
        )
    return TenantMap(_parse_tenant(i, e) for i, e in enumerate(entries))


def load_tenants(path: str) -> TenantMap:
    """Load ``path`` — YAML when PyYAML is present, else strict JSON
    (the watchlist/SLO loaders' exact gating)."""
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    try:
        import yaml  # type: ignore[import-untyped]

        data = yaml.safe_load(text)
    except ImportError:
        try:
            data = json.loads(text)
        except ValueError as e:
            raise TenancyError(
                f"{path}: not valid JSON (and PyYAML is unavailable): {e}"
            ) from e
    except Exception as e:  # yaml.YAMLError — malformed document
        raise TenancyError(f"{path}: cannot parse: {e}") from e
    return parse_tenants(data)


class _Waiter:
    """One queued acquire: its wakeup event and the granted flag (both
    owned by the queue's lock; the event is the only cross-thread
    signal)."""

    __slots__ = ("event", "granted")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.granted = False


class FairSlotQueue:
    """Deficit-round-robin concurrency gate: ``slots`` shared slots,
    one sub-queue per tenant, weighted-fair grants.

    The DRR invariant: every rotation of the backlog credits each
    queued tenant ``quantum * weight(tenant)``; a grant costs 1.0.  A
    tenant's service rate under full backlog is therefore proportional
    to its weight, and — the starvation-proof property — ANY queued
    tenant is granted within a bounded number of grants to everyone
    else (its credit grows every rotation and is never confiscated
    while it waits).  Credit does not bank across idle periods: a
    tenant whose sub-queue empties is dropped from the rotation and
    re-enters at zero, so bursting after a quiet hour earns no stored
    advantage.

    ``acquire``/``release`` pair like a semaphore (``release`` hands
    the freed slot straight to the next DRR pick, so the slot count is
    exact under concurrency — pinned by the sanitize hammer).
    """

    def __init__(self, slots: int, *, weight_of=None, quantum: float = 1.0):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if quantum <= 0:
            raise ValueError(f"quantum must be > 0, got {quantum}")
        self._slots = int(slots)
        self._weight_of = weight_of
        self._quantum = float(quantum)
        self._lock = threading.Lock()
        self._free = self._slots
        self._queues: dict[str, collections.deque] = {}
        self._order: collections.deque = collections.deque()
        self._deficits: dict[str, float] = {}
        self._active: dict[str, int] = {}
        self._waiting = 0

    def _weight(self, tenant: str) -> float:
        if self._weight_of is None:
            return 1.0
        w = float(self._weight_of(tenant))
        return w if w > 0 else 1.0

    def _enqueue_locked(self, tenant: str) -> "_Waiter":
        w = _Waiter()
        q = self._queues.get(tenant)
        if q is None:
            q = collections.deque()
            self._queues[tenant] = q
            self._deficits[tenant] = 0.0
            self._order.append(tenant)
        q.append(w)
        self._waiting += 1
        return w

    def _drop_tenant_locked(self, tenant: str) -> None:
        self._queues.pop(tenant, None)
        self._deficits.pop(tenant, None)
        try:
            self._order.remove(tenant)
        except ValueError:
            pass

    def _grant_locked(self):
        """The DRR pick: ``(waiter, tenant)`` or ``(None, None)`` when
        nobody waits.  Terminates: every full rotation credits each
        queued tenant ``quantum * weight > 0``, and empty sub-queues
        are pruned as visited, so while the rotation is non-empty some
        tenant crosses the unit cost within finitely many rotations."""
        while self._order:
            tenant = self._order[0]
            q = self._queues.get(tenant)
            if not q:
                self._order.popleft()
                self._queues.pop(tenant, None)
                self._deficits.pop(tenant, None)
                continue
            if self._deficits[tenant] >= 1.0:
                self._deficits[tenant] -= 1.0
                w = q.popleft()
                self._waiting -= 1
                if not q:
                    # Idle tenants bank no credit (classic DRR).
                    self._order.popleft()
                    self._queues.pop(tenant, None)
                    self._deficits.pop(tenant, None)
                return w, tenant
            self._deficits[tenant] += self._quantum * self._weight(tenant)
            self._order.rotate(-1)
        return None, None

    def try_acquire(self, tenant: str) -> bool:
        """Non-blocking: take a slot only when one is free AND nobody
        is queued (a free slot with a backlog belongs to the DRR pick,
        not to whoever races in)."""
        with self._lock:
            if self._free > 0 and self._waiting == 0:
                self._free -= 1
                self._active[tenant] = self._active.get(tenant, 0) + 1
                return True
            return False

    def acquire(self, tenant: str, timeout: float | None = None) -> bool:
        """Take a slot, queueing up to ``timeout`` seconds behind this
        tenant's sub-queue.  Returns False on timeout (the waiter is
        withdrawn); a grant that races the timeout is honored — the
        slot is already ours, so the caller proceeds."""
        with self._lock:
            if self._free > 0 and self._waiting == 0:
                self._free -= 1
                self._active[tenant] = self._active.get(tenant, 0) + 1
                return True
            w = self._enqueue_locked(tenant)
        if w.event.wait(timeout):
            return True
        with self._lock:
            if w.granted:
                return True
            try:
                self._queues[tenant].remove(w)
            except (KeyError, ValueError):
                return w.granted  # pruned by a racing grant
            self._waiting -= 1
            if not self._queues[tenant]:
                self._drop_tenant_locked(tenant)
            return False

    def release(self, tenant: str) -> None:
        """Return the tenant's slot; the freed slot goes straight to
        the next DRR pick (never back to the free pool while anyone
        waits)."""
        with self._lock:
            n = self._active.get(tenant, 0)
            if n <= 0:
                raise ValueError(
                    f"release without acquire for tenant {tenant!r}"
                )
            if n == 1:
                self._active.pop(tenant, None)
            else:
                self._active[tenant] = n - 1
            w, grantee = self._grant_locked()
            if w is None:
                self._free += 1
            else:
                self._active[grantee] = self._active.get(grantee, 0) + 1
                w.granted = True
                w.event.set()

    def stats(self) -> dict:
        with self._lock:
            return {
                "slots": self._slots,
                "free": self._free,
                "waiting": self._waiting,
                "active": dict(self._active),
                "queued": {t: len(q) for t, q in self._queues.items() if q},
            }
