"""Per-watch alert state machine: ok → breached → recovered.

A watch with a ``min_replicas`` threshold transitions when its evaluated
capacity crosses it:

* ``ok``        — never breached since the timeline started;
* ``breached``  — current capacity < ``min_replicas``;
* ``recovered`` — capacity back at/above the threshold after at least
  one breach (distinguishable from ``ok`` on purpose: "fine now, but it
  dipped while you were asleep" is the whole point of a timeline).

Transitions are *returned* to the caller (the timeline appends them to
the ``-timeline-log`` JSONL and bumps the breach counters) rather than
observed via callbacks — the machine itself is pure state, trivially
testable, and takes no locks (the timeline serializes observations).
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = [
    "ALERT_OK",
    "ALERT_BREACHED",
    "ALERT_RECOVERED",
    "ALERT_STATE_CODES",
    "WatchAlert",
]

ALERT_OK = "ok"
ALERT_BREACHED = "breached"
ALERT_RECOVERED = "recovered"

#: Gauge encoding (``kccap_watch_alert_state``): 0 is the healthy floor
#: so any nonzero sample means "look at this watch".
ALERT_STATE_CODES = {ALERT_OK: 0, ALERT_RECOVERED: 1, ALERT_BREACHED: 2}


@dataclass
class WatchAlert:
    """Alert state for one watch (``min_replicas`` may be ``None`` —
    such a watch is observed but never transitions)."""

    name: str
    min_replicas: int | None = None
    state: str = ALERT_OK
    breaches: int = 0
    recoveries: int = 0
    last_total: int | None = None
    since_generation: int | None = None  # generation of the last transition

    def update(self, total: int, generation: int) -> str | None:
        """Fold one evaluated capacity in; returns the transition entered
        (``"breached"`` / ``"recovered"``) or ``None`` when state held."""
        self.last_total = int(total)
        if self.min_replicas is None:
            return None
        breached_now = total < self.min_replicas
        if breached_now and self.state != ALERT_BREACHED:
            self.state = ALERT_BREACHED
            self.breaches += 1
            self.since_generation = generation
            return ALERT_BREACHED
        if not breached_now and self.state == ALERT_BREACHED:
            self.state = ALERT_RECOVERED
            self.recoveries += 1
            self.since_generation = generation
            return ALERT_RECOVERED
        return None

    @property
    def state_code(self) -> int:
        return ALERT_STATE_CODES[self.state]

    def to_wire(self) -> dict:
        """JSON-able state (``timeline`` op, ``/healthz``, doctor)."""
        return {
            "state": self.state,
            "min_replicas": self.min_replicas,
            "breaches": self.breaches,
            "recoveries": self.recoveries,
            "last_total": self.last_total,
            "since_generation": self.since_generation,
        }
