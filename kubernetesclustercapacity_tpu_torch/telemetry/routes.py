"""Route counters: which program each routed sweep dispatch took, and why.

The sweep dispatchers (:func:`..ops.fused_fit.sweep_auto`, its grouped
form, :func:`..ops.fused_multi.sweep_multi_auto`) choose between a fused
int32 kernel and the exact int64 program by proof.  The reply carries only
the kernel label; these two families of the process registry keep the
label and the reason together.  The grid form of ``topology_spread``
(:meth:`..models.capacity.CapacityModel.topology_spread_grid`) needs
per-node fits, so it always takes the exact program's per-node form: it
counts as ``kernel="torch_int64_per_node"``, ``reason="topology_spread"``.

``kccap_route_dispatches_total{kernel, reason}``
    dispatches (a folded batch is one);
``kccap_route_scenarios_total{kernel, reason}``
    the scenarios those dispatches answered.

``kernel`` is the label the dispatch returns.  ``reason`` is
``eligible`` (the proof held), ``forced`` (``kernel="exact"``), or the
first condition of the proof, or of the route's preconditions, that
failed: for the 2-resource sweep ``int32_range``, ``mem_not_kib``,
``zero_request``, ``total_bound`` (:func:`..ops.fused_fit.
sweep_proof_failure`); for the R-resource sweep ``row_count``,
``negative_request``, ``int32_range``, ``row_scale``, ``total_bound``,
``max_per_node``, ``per_scenario_mask`` (:func:`..ops.fused_multi.
multi_proof`).

The families live in the process registry beside compilewatch's, never in
a server's own registry, and stay out of the registry's Prometheus text
(``scrape=False``): the families a server serves are the JAX server's,
and the JAX package routes without counting.  The registry's snapshot
holds them (the ``info`` op's ``metrics`` on a server of the process
registry, the benchmark's marks).  With ``KCCAP_TELEMETRY=0`` nothing
touches the registry.
"""

from __future__ import annotations

from kubernetesclustercapacity_tpu_torch.telemetry.metrics import enabled

__all__ = ["observe_route"]

_MET: dict | None = None


def _metrics() -> dict:
    global _MET
    if _MET is None:
        from kubernetesclustercapacity_tpu_torch.telemetry.metrics import REGISTRY

        _MET = {
            "dispatches": REGISTRY.counter(
                "kccap_route_dispatches_total",
                "Routed sweep dispatches, by the kernel taken and the "
                "reason (eligible, forced or the failed proof condition).",
                ("kernel", "reason"),
                scrape=False,
            ),
            "scenarios": REGISTRY.counter(
                "kccap_route_scenarios_total",
                "Scenarios answered by routed sweep dispatches, by the "
                "kernel taken and the reason.",
                ("kernel", "reason"),
                scrape=False,
            ),
        }
    return _MET


def observe_route(kernel: str, reason: str, scenarios: int) -> None:
    """Count one dispatch of ``scenarios`` scenarios on ``kernel``."""
    if not enabled():
        return
    m = _metrics()
    m["dispatches"].labels(kernel=kernel, reason=reason).inc()
    m["scenarios"].labels(kernel=kernel, reason=reason).inc(scenarios)
