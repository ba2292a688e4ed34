"""Audit subsystem (counterpart of ``kubernetesclustercapacity_tpu/audit/``):
durable request/state history, deterministic replay, and shadow-oracle
parity monitoring.

* :mod:`.log` — the append-only JSONL audit log of snapshot generations
  (checkpoints and invertible diffs, digest-chained) and requests, and
  its crash-tolerant reader.  The on-disk format is the JAX package's,
  so either package reads, and replays, the other's logs;
* :mod:`.replay` — offline reconstruction of any recorded generation and
  re-answering of recorded requests through a private server on the
  chosen device (``kccap-torch -replay``);
* :mod:`.shadow` — an off-request-path sampler re-checking a fraction of
  live sweep replies against the pure-Python oracle.
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
from kubernetesclustercapacity_tpu_torch.audit.replay import (
    Replayer,
    replay_shadow_bundle,
)
from kubernetesclustercapacity_tpu_torch.audit.shadow import ShadowSampler

__all__ = [
    "AuditError",
    "AuditLog",
    "AuditReader",
    "Replayer",
    "ShadowSampler",
    "canonical_result",
    "canonical_result_digest",
    "replay_shadow_bundle",
    "snapshot_from_summary",
    "strip_args",
]
