"""Audit subsystem (counterpart of ``kubernetesclustercapacity_tpu/audit/``).

Only :mod:`.log` is ported: the append-only JSONL audit log of snapshot
generations (checkpoints and invertible diffs, digest-chained) and
requests, and its crash-tolerant reader.  The on-disk format is the JAX
package's, so the forecast's history feed (:mod:`..stochastic.history`)
reads logs either package wrote.  Deterministic replay and the shadow
oracle sampler are not ported yet.
"""

from kubernetesclustercapacity_tpu_torch.audit.log import (
    AuditError,
    AuditLog,
    AuditReader,
    canonical_result,
    canonical_result_digest,
    snapshot_from_summary,
    strip_args,
)

__all__ = [
    "AuditError",
    "AuditLog",
    "AuditReader",
    "canonical_result",
    "canonical_result_digest",
    "snapshot_from_summary",
    "strip_args",
]
