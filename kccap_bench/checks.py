"""What decides ``correct``: the kept replies against the plain reference.

Every number compared has the limit 0: the answers are replica counts,
and the configuration promises them exact (the Go CLI's, or the
scheduler's, to the unit).

* ``totals_off``: kept spec totals that differ from the reference's;
* ``sched_off``: kept schedulable flags that differ;
* ``unanswered``: kept requests with no reply by the deadline;
* a kind may add its own (``update_numbers`` of the ``churn`` kind).
"""

from __future__ import annotations

import numpy as np

__all__ = ["kept_keys", "compare", "LIMITS"]

LIMITS = {"totals_off": 0, "sched_off": 0, "unanswered": 0,
          "updates_off": 0, "stale_reads": 0}


def kept_keys(records) -> list:
    """``(stream, prefix, i, generation)`` of every kept query reply: the
    ``then`` replies of a stream whose requests are not queries, the
    requests themselves otherwise."""
    keys = []
    for k, rec in enumerate(records):
        prefix = "then_" if rec.has_then else ""
        gens = getattr(rec, prefix + "generation")
        keep = rec.stream.then_keep if rec.has_then else rec.stream.keep
        for i in sorted(keep):
            keys.append((k, prefix, i, int(gens[i])))
    return keys


def compare(records, keys, expected: dict) -> dict:
    totals_off = sched_off = unanswered = 0
    for key in keys:
        k, prefix, i, _gen = key
        reply = getattr(records[k], prefix + "replies").get(i)
        if reply is None:
            unanswered += 1
            continue
        want_tot, want_sched = expected.get(key, (None, None))
        got_tot = np.asarray(reply.get("totals", []), dtype=np.int64)
        got_sched = np.asarray(reply.get("schedulable", []), dtype=bool)
        if want_tot is None or got_tot.shape != want_tot.shape or \
                got_sched.shape != want_sched.shape:
            n = 0 if want_tot is None else len(want_tot)
            totals_off += max(n, 1)
            sched_off += max(n, 1)
            continue
        totals_off += int(np.count_nonzero(got_tot != want_tot))
        sched_off += int(np.count_nonzero(got_sched != want_sched))
    return {"totals_off": totals_off, "sched_off": sched_off,
            "unanswered": unanswered}
