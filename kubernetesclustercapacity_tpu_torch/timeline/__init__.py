"""Capacity timeline (counterpart of ``kubernetesclustercapacity_tpu/timeline/``).

Four pieces, as in the JAX package:

* :mod:`.watchlist` — named what-if scenarios (``-watch FILE``) the
  timeline re-evaluates on every snapshot publish;
* :mod:`.diff` — the generation-to-generation node-set diff;
* :mod:`.alerts` — the per-watch ok → breached → recovered state machine
  behind the ``kccap_watch_*`` gauges and ``/healthz`` (the device-memory
  ledger's leak alert rides it too);
* :mod:`.history` — :class:`~.history.CapacityTimeline`, the bounded ring
  of per-generation records the server feeds from its publish paths, with
  the attributed deltas.

Watch capacities are evaluated through :func:`~..explain.explain_snapshot`
on the timeline's device, whose fit column equals
:func:`~..ops.fit.fit_per_node`, so a timeline capacity equals a cold
``fit`` of the same generation.

:mod:`.history` imports the explain program and the taint mask inside the
methods that run them: the device cache's ledger imports :mod:`.alerts`
while the device cache itself is loading, and both reach the device
cache.
"""

from kubernetesclustercapacity_tpu_torch.timeline.alerts import (  # noqa: F401
    ALERT_BREACHED,
    ALERT_OK,
    ALERT_RECOVERED,
    WatchAlert,
)
from kubernetesclustercapacity_tpu_torch.timeline.diff import (  # noqa: F401
    NODE_FIELDS,
    SnapshotDiff,
    diff_summaries,
    node_summary,
    snapshot_digest,
)
from kubernetesclustercapacity_tpu_torch.timeline.history import (  # noqa: F401
    CapacityTimeline,
    GenerationRecord,
)
from kubernetesclustercapacity_tpu_torch.timeline.watchlist import (  # noqa: F401
    WatchError,
    WatchSpec,
    load_watchlist,
    parse_watchlist,
)
