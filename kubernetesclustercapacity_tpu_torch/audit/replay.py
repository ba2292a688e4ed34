"""Deterministic replay: any recorded anomaly becomes an offline repro.

Counterpart of ``kubernetesclustercapacity_tpu/audit/replay.py``; the
private server runs on the ``device`` the caller names (``"cuda"`` by
default), so a replayed sweep launches kernel B1 as a served one does.

:class:`Replayer` re-answers recorded requests against audit-log
reconstructions of the generations that originally answered them,
through the REAL dispatch path — a private :class:`~..service.server.
CapacityServer` (micro-batching off: a replay is sequential, and a
batch of one is pinned identical to solo anyway) — and asserts the
canonical result digest matches the recorded one.  Volatile fields
(kernel choice, fused-path notes, rendered report text) are stripped by
the canonicalization on BOTH sides, so a divergence is a semantics
divergence, never a backend cosmetic.

Replayable ops are the pure snapshot queries: ``sweep``, ``explain``,
and plain-flag ``fit``.  Requests that consumed raw fixture objects the
audit vocabulary does not carry (drain, priorities, spec-field
constraints, multi-resource sweeps over extended columns) are recorded
for the forensic trail but reported ``skipped`` with the reason.

Surfaced as ``kccap -replay DIR`` (all requests + the digest chain),
``-replay-ref SEGMENT:OFFSET`` (one record — the ``audit_ref`` a
flight-recorder ``dump`` prints, copy-paste round trip), and
``-replay-generation G`` (state reconstruction only), with
``kccap-torch`` for ``kccap``.
"""

from __future__ import annotations

import numpy as np

from kubernetesclustercapacity_tpu_torch.audit.log import (
    AuditReader,
    canonical_result_digest,
)

__all__ = ["Replayer", "replay_shadow_bundle"]

#: Ops whose full answer is a function of the packed snapshot alone.
#: ``gang`` qualifies because node labels ride audit checkpoints (the
#: topology hierarchy reconstructs with the fit columns), and the gang
#: result's ``engine`` field is canonical-stripped like ``kernel``.
#: ``optimize`` qualifies because its canonical digest keeps only the
#: closed-form integer packing answer (rounded/FFD totals, demand,
#: schedulability) — every float solver artifact is per-op
#: canonical-stripped, so a solve recorded on one device verifies on
#: another.
#: ``forecast`` qualifies because growth rates ride the request args
#: explicitly (the server refuses to fit trends; that happens client-
#: side from the audit log itself) — the projection is a pure, seeded
#: function of the reconstructed snapshot.  ``plan`` (the catalog
#: form) likewise: the per-op canonical digest keeps only the integer
#: purchase answer, stripping the float bounds/prices/certificates.
_REPLAYABLE = frozenset(
    {"sweep", "explain", "fit", "gang", "optimize", "forecast", "plan"}
)

#: fit/sweep args that pull in raw fixture objects or columns outside
#: the audit vocabulary — present means "recorded, not replayable".
_FIXTURE_ARGS = frozenset(
    {
        "tolerations", "node_selector", "affinity_terms",
        "anti_affinity_labels", "spread", "extended_requests",
        "priority", "priorities", "namespace",
    }
)


class Replayer:
    """Re-answer recorded requests from audit-log reconstructions.

    Owns one private dispatch server on ``device``, lazily built and
    re-pointed at each generation as the replay walks the log;
    ``close()`` tears it down.  Context-manager friendly.
    """

    def __init__(self, reader: AuditReader, *, device="cuda") -> None:
        self._reader = reader
        self._device = device
        self._server = None
        self._server_generation = None

    def __enter__(self) -> "Replayer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        if self._server is not None:
            try:
                self._server.shutdown()
            finally:
                self._server = None
                self._server_generation = None

    def _dispatch(self, generation: int, msg: dict):
        from kubernetesclustercapacity_tpu_torch.service.server import (
            CapacityServer,
        )

        snap = self._reader.snapshot_at(generation)
        if self._server is None:
            self._server = CapacityServer(
                snap, port=0, batch_window_ms=0.0, flight_records=1,
                device=self._device,
            )
            self._server_generation = generation
        elif self._server_generation != generation:
            self._server.replace_snapshot(snap)
            self._server_generation = generation
        return self._server.dispatch(msg)

    @staticmethod
    def _skip_reason(rec: dict) -> str | None:
        op = rec.get("op")
        args = rec.get("args") or {}
        if op not in _REPLAYABLE:
            return f"op {op!r} is recorded but not replayable"
        if op == "gang" and "ranks" not in args:
            # The watch-status form answers from the LIVE timeline's
            # alert state, not the snapshot — recorded for the
            # forensic trail, unreplayable by construction.
            return (
                "gang watch-status form reads the live timeline, "
                "not the snapshot"
            )
        if op == "forecast" and "usage" not in args:
            # Same split as gang: the status form is timeline state.
            return (
                "forecast watch-status form reads the live timeline, "
                "not the snapshot"
            )
        if op == "plan" and "catalog" not in args:
            # The legacy node_template form consumes the capacity
            # model's fixture view, which the audit vocabulary does
            # not carry; only the catalog form is a pure snapshot
            # function.
            return (
                "plan node_template form reads the capacity model, "
                "not the snapshot alone"
            )
        blocked = sorted(_FIXTURE_ARGS & set(args))
        if blocked:
            return (
                "args need raw fixture objects the audit vocabulary "
                f"does not carry: {', '.join(blocked)}"
            )
        return None

    def replay_record(self, rec: dict) -> dict:
        """Replay one request record → outcome dict (``status`` one of
        ``ok`` / ``mismatch`` / ``skipped`` / ``error``)."""
        out = {
            "ref": rec.get("_ref", ""),
            "op": rec.get("op"),
            "generation": rec.get("generation"),
            "recorded_digest": rec.get("result_digest", ""),
        }
        if rec.get("kind") != "request":
            out.update(
                status="error",
                reason=f"not a request record (kind={rec.get('kind')!r})",
            )
            return out
        reason = self._skip_reason(rec)
        if reason is not None:
            out.update(status="skipped", reason=reason)
            return out
        msg = {"op": rec["op"], **(rec.get("args") or {})}
        msg.pop("op", None)
        msg["op"] = rec["op"]
        try:
            result = self._dispatch(int(rec["generation"]), msg)
        except Exception as e:  # noqa: BLE001 - the error IS the answer
            replay_error = f"{type(e).__name__}: {e}"
            if rec.get("status") == "error":
                recorded = rec.get("error", "")
                out["replayed_error"] = replay_error
                out["status"] = (
                    "ok" if replay_error == recorded else "mismatch"
                )
                if out["status"] == "mismatch":
                    out["recorded_error"] = recorded
                return out
            out.update(status="error", reason=replay_error)
            return out
        if rec.get("status") == "error":
            out.update(
                status="mismatch",
                reason="recorded dispatch raised; replay answered",
            )
            return out
        digest = canonical_result_digest(rec["op"], result)
        out["replayed_digest"] = digest
        out["status"] = (
            "ok" if digest == rec.get("result_digest", "") else "mismatch"
        )
        return out

    def replay_all(
        self,
        *,
        ops: tuple[str, ...] | None = None,
        tenant: str | None = None,
    ) -> dict:
        """Verify the generation digest chain, then replay every
        recorded request (optionally only ``ops``, optionally only one
        ``tenant`` — the server stamps the DERIVED tenant into each
        audited request's args when tenancy is armed, so one tenant's
        traffic replays in isolation).  The summary dict is the
        ``kccap -replay`` report body; ``clean`` is the exit verdict
        (no mismatches, no replay errors, chain intact)."""
        chain_error = None
        try:
            verified = self._reader.verify_chain()
        except Exception as e:  # noqa: BLE001 - report, don't traceback
            chain_error = f"{type(e).__name__}: {e}"
            verified = []
        outcomes = []
        for rec in self._reader.requests():
            if ops is not None and rec.get("op") not in ops:
                continue
            if (
                tenant is not None
                and (rec.get("args") or {}).get("tenant") != tenant
            ):
                continue
            outcomes.append(self.replay_record(rec))
        counts = {"ok": 0, "mismatch": 0, "skipped": 0, "error": 0}
        for o in outcomes:
            counts[o["status"]] = counts.get(o["status"], 0) + 1
        return {
            "directory": self._reader.directory,
            "generations_verified": verified,
            "chain_error": chain_error,
            "recovered_tail_records": self._reader.recovered_tail,
            "requests": len(outcomes),
            "counts": counts,
            "outcomes": outcomes,
            "clean": (
                chain_error is None
                and counts["mismatch"] == 0
                and counts["error"] == 0
            ),
        }


def replay_shadow_bundle(
    reader: AuditReader, bundle: dict, *, device="cuda"
) -> dict:
    """Re-run a shadow-divergence repro bundle offline: reconstruct the
    recorded generation, dispatch the recorded sweep through the live
    kernel path on ``device``, and re-check against the pure-Python
    oracle.  Confirms
    (or refutes) the divergence the sampler alarmed on — with the same
    fault present, the mismatch reproduces; on a healthy build it does
    not."""
    from kubernetesclustercapacity_tpu_torch.audit.shadow import oracle_totals
    from kubernetesclustercapacity_tpu_torch.scenario import ScenarioGrid

    snap = reader.snapshot_at(int(bundle["generation"]))
    grid = ScenarioGrid(
        cpu_request_milli=np.asarray(bundle["cpu_request_milli"]),
        mem_request_bytes=np.asarray(bundle["mem_request_bytes"]),
        replicas=np.asarray(bundle["replicas"]),
    )
    with Replayer(reader, device=device) as rp:
        result = rp._dispatch(
            int(bundle["generation"]),
            {
                "op": "sweep",
                "cpu_request_milli": grid.cpu_request_milli.tolist(),
                "mem_request_bytes": grid.mem_request_bytes.tolist(),
                "replicas": grid.replicas.tolist(),
            },
        )
    served = [int(t) for t in result["totals"]]
    oracle = oracle_totals(snap, grid)
    rows = [
        {
            "scenario": s,
            "served_total": served[s],
            "oracle_total": oracle[s],
        }
        for s in range(grid.size)
        if served[s] != oracle[s]
    ]
    return {
        "generation": int(bundle["generation"]),
        "digest": bundle.get("digest"),
        "scenarios": grid.size,
        "diverged": bool(rows),
        "rows": rows,
        "served_matches_bundle": served
        == [int(t) for t in bundle.get("served_totals", [])],
    }
