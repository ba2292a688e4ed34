"""Cluster-source resolution for the CLI.

Counterpart of ``kubernetesclustercapacity_tpu/sources.py``: one place owns
the rules for turning ``-snapshot``/``-semantics`` into a packed snapshot:

* ``.npz`` checkpoints carry the semantics they were packed with; an
  explicit conflicting request is an error (never silently mix packings);
* fixture ``.json`` re-packs under the requested semantics (default
  ``reference``).

The live-cluster source and extended-resource columns are not ported yet.
"""

from __future__ import annotations

import os

from kubernetesclustercapacity_tpu_torch.fixtures import load_fixture
from kubernetesclustercapacity_tpu_torch.snapshot import (
    ClusterSnapshot,
    load_snapshot,
    snapshot_from_fixture,
)

__all__ = ["SourceError", "resolve_source"]


class SourceError(ValueError):
    """Unusable cluster source (missing file, semantics conflict)."""


def resolve_source(
    path: str, semantics: str | None
) -> tuple[dict | None, ClusterSnapshot, str]:
    """Load a fixture/.npz source → ``(fixture|None, snapshot, semantics)``.

    ``semantics=None`` means "not explicitly requested": adopt the
    checkpoint's stored packing for ``.npz``, default ``reference``
    otherwise.
    """
    if not os.path.exists(path):
        raise SourceError(f"snapshot file not found: {path}")
    if path.endswith(".npz"):
        snap = load_snapshot(path)
        if semantics is not None and semantics != snap.semantics:
            raise SourceError(
                f"snapshot {path} was packed with -semantics "
                f"{snap.semantics}; re-pack from a fixture to run {semantics}"
            )
        return None, snap, snap.semantics
    semantics = semantics or "reference"
    fixture = load_fixture(path)
    return fixture, snapshot_from_fixture(fixture, semantics=semantics), semantics
